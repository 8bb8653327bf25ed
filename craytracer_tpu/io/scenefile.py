"""Reference-compatible scene-file parser.

The reference's grammar (`scene/scenefile.h:92-791`, `buildscene.h:344-539`)
is positional: each entry reads a fixed keyword/value sequence. The shipped
scene files predate the parser in places (cornell_box.txt uses an older
AMB_COLOR/DIFF_COLOR material block and lacks the film header;
config.txt points at a scene that does not exist), so a literal port could
not even load the fixtures. This parser is keyword-driven and tolerant: it
accepts the current grammar, the legacy material keys, missing headers
(defaults), and C-`atof` malformed floats — every shipped scene loads.

Returns (Scene pytree, Camera, Film).
"""

from __future__ import annotations

import math
import os

import numpy as np

from craytracer_tpu.camera import Camera, Film, make_camera
from craytracer_tpu.constants import PI, PRESET_COLORS
from craytracer_tpu.io.tokenizer import TokenStream, atof, tokenize
from craytracer_tpu.scene import SceneBuilder
from craytracer_tpu.scene import types as T

_OBJECT_TYPES = {
    "SPHERE", "PLANE", "RECTANGLE", "TRIANGLE", "BOX", "OPENCYLINDER",
    "SOLIDCYLINDER", "DISK", "TORUS", "MESH",
}
_MATERIAL_TYPES = {
    "MATTE", "MIRROR", "TRANSPARENT", "EMISSIVE", "PLASTIC", "GLASS", "METAL",
    "REFLECTIVE", "PHONG",  # legacy grammars
}
_BLOCK_STARTERS = {"MATERIAL", "OBJECT", "ENV_LIGHT", "END_MATERIALS"}

# Every attribute keyword in the grammar (current + legacy forms). Values are
# recognized positionally: the first token after a key is always a value, and
# value runs end at the next known key / block starter / END.
_KNOWN_KEYS = {
    # materials
    "NAME", "COLOR", "SIGMA", "NORMAL_MAP", "TEXTURE", "KD", "KD_TEXTURE",
    "IMPORTANCE",
    "KS", "ROUGHNESS", "IOR_IN", "IOR_OUT", "CF_IN", "CF_OUT", "INTENSITY",
    "TYPE",
    # legacy material keys (example_scene.txt / cornell_box.txt era)
    "SHADOWED", "AMB_COLOR", "AMB_CONSTANT", "DIFF_COLOR", "DIFF_CONSTANT",
    "SPEC_COLOR", "SPEC_CONSTANT", "EXP",
    # objects
    "CAST_SHADOW", "RADIUS", "CENTER", "PHI", "MIN_THETA", "MAX_THETA",
    "MATERIAL", "POINT", "NORMAL", "WIDTH", "HEIGHT", "V0", "V1", "V2",
    "LENGTH", "LOCATION", "SCALE", "ORIENTATION", "NORMAL_TYPE",
    "SWEPT_RADIUS", "TUBE_RADIUS", "FILE", "FILE_NAME", "SMOOTH", "SCALING",
    # delta-light blocks (grammar extension, see POINT_LIGHT below)
    "DIST_ATTEN", "DIRECTION",
}


def _is_block_start(ts: TokenStream) -> bool:
    """True when the stream is positioned at a new top-level block.

    `MATERIAL` is ambiguous: `MATERIAL MATTE` starts a material definition,
    `MATERIAL emissive1` inside an OBJECT names its material — disambiguate
    by whether the following token is a material type."""
    tok = ts.peek()
    if tok in ("OBJECT", "ENV_LIGHT", "END_MATERIALS", "POINT_LIGHT",
               "DIRECTIONAL_LIGHT"):
        return True
    if tok == "MATERIAL":
        nxt = ts.tokens[ts.pos + 1] if ts.pos + 1 < len(ts.tokens) else None
        return nxt in _MATERIAL_TYPES
    return False


def _parse_color(ts: TokenStream):
    """Preset name or 3 floats (parseColor, scene/scenefile.h:77-90)."""
    tok = ts.next()
    if tok in PRESET_COLORS:
        return PRESET_COLORS[tok]
    r = atof(tok or "")
    return (r, ts.next_float(), ts.next_float())


def _collect_block(ts: TokenStream) -> dict:
    """Read KEY [values...] pairs until the next block starter or END.
    Values for a key are all tokens up to the next recognized key."""
    kv: dict[str, list[str]] = {}
    while not ts.eof():
        if _is_block_start(ts):
            break
        tok = ts.next()
        if tok == "END":
            break
        vals: list[str] = []
        # the first token after a key is always a value (handles values that
        # collide with key names, e.g. ENV_LIGHT "TYPE TEXTURE")
        if not ts.eof() and not _is_block_start(ts) and ts.peek() != "END":
            vals.append(ts.next())
        while not ts.eof():
            if _is_block_start(ts):
                break
            nxt = ts.peek()
            if nxt == "END" or nxt in _KNOWN_KEYS:
                break
            vals.append(ts.next())
        kv[tok] = vals
    return kv


def _color_from(vals: list[str], default=(0.0, 0.0, 0.0)):
    if not vals:
        return default
    if vals[0] in PRESET_COLORS:
        return PRESET_COLORS[vals[0]]
    nums = [atof(v) for v in vals[:3]]
    while len(nums) < 3:
        nums.append(0.0)
    return tuple(nums)


def _vec3_from(vals: list[str] | None, default=(0.0, 0.0, 0.0)):
    if not vals:
        return default
    nums = [atof(v) for v in vals[:3]]
    while len(nums) < 3:
        nums.append(0.0)
    return tuple(nums)


def _f(vals: list[str], default=0.0):
    return atof(vals[0]) if vals else default


def _parse_material(builder: SceneBuilder, mat_type: str, kv: dict, search_dirs):
    name = (kv.get("NAME") or ["unnamed"])[0]
    diffuse_tex = -1
    if "TEXTURE" in kv or "KD_TEXTURE" in kv:
        tex_file = (kv.get("TEXTURE") or kv.get("KD_TEXTURE"))[0]
        diffuse_tex = _load_texture(builder, tex_file, search_dirs)
    # tolerance: `COLOR TEXTURE <file>` (the reference grammar is a bare
    # `TEXTURE <file>` REPLACING the COLOR line — parseMatteEntry reads
    # the token in COLOR's position and compares it to "TEXTURE",
    # scene/scenefile.h:140-151; both forms are accepted here)
    cvals = kv.get("COLOR")
    if diffuse_tex < 0 and cvals and cvals[0] == "TEXTURE" and len(cvals) > 1:
        diffuse_tex = _load_texture(builder, cvals[1], search_dirs)
        kv = dict(kv)
        kv["COLOR"] = ["0.5", "0.5", "0.5"]  # table color unused when textured

    if mat_type == "MATTE":
        color = _color_from(kv.get("COLOR") or kv.get("DIFF_COLOR"), (0.5, 0.5, 0.5))
        sigma = _f(kv.get("SIGMA"), 0.0)
        normal_tex = -1
        if "NORMAL_MAP" in kv and kv["NORMAL_MAP"]:
            normal_tex = _load_texture(builder, kv["NORMAL_MAP"][0], search_dirs)
        builder.add_matte(name, color, sigma, diffuse_tex=diffuse_tex,
                          normal_tex=normal_tex)
    elif mat_type == "MIRROR":
        builder.add_mirror(name, _color_from(kv.get("COLOR"), (1, 1, 1)))
    elif mat_type == "TRANSPARENT":
        builder.add_transparent(
            name,
            ior_in=_f(kv.get("IOR_IN"), 1.5),
            ior_out=_f(kv.get("IOR_OUT"), 1.0),
            cf_in=_color_from(kv.get("CF_IN"), (1, 1, 1)),
            cf_out=_color_from(kv.get("CF_OUT"), (1, 1, 1)),
        )
    elif mat_type == "EMISSIVE":
        builder.add_emissive(name, _color_from(kv.get("COLOR"), (1, 1, 1)),
                             _f(kv.get("INTENSITY"), 1.0))
    elif mat_type == "PLASTIC":
        builder.add_plastic(
            name,
            kd=_color_from(kv.get("KD"), (0.5, 0.5, 0.5)),
            ks=_color_from(kv.get("KS"), (0.5, 0.5, 0.5)),
            roughness=_f(kv.get("ROUGHNESS"), 0.1),
            diffuse_tex=diffuse_tex,
        )
    elif mat_type == "GLASS":
        builder.add_glass(name, roughness=_f(kv.get("ROUGHNESS"), 0.0))
    elif mat_type == "METAL":
        builder.add_metal(name, preset=(kv.get("TYPE") or ["GOLD"])[0],
                          roughness=_f(kv.get("ROUGHNESS"), 0.05))
    elif mat_type == "REFLECTIVE":
        # Legacy grammar (example_scene.txt): map to plastic with the listed
        # diffuse/specular colors and constants.
        kd = _color_from(kv.get("DIFF_COLOR"), (0.5, 0.5, 0.5))
        ks = _color_from(kv.get("SPEC_COLOR"), (0.5, 0.5, 0.5))
        kd_c = _f(kv.get("DIFF_CONSTANT"), 1.0)
        ks_c = _f(kv.get("SPEC_CONSTANT"), 1.0)
        builder.add_plastic(name, kd=tuple(c * kd_c for c in kd),
                            ks=tuple(c * ks_c for c in ks), roughness=0.05)
    else:
        builder.add_matte(name, (0.5, 0.5, 0.5))


def _load_texture(builder: SceneBuilder, file_name: str, search_dirs) -> int:
    from craytracer_tpu.io.teximage import load_texture_image

    for d in search_dirs:
        p = os.path.join(d, file_name)
        if os.path.exists(p):
            return builder.add_texture(file_name, load_texture_image(p))
    return -1


def _parse_object(builder: SceneBuilder, obj_type: str, kv: dict, search_dirs):
    mat = (kv.get("MATERIAL") or ["__default__"])[0]
    if obj_type == "SPHERE":
        builder.add_sphere(
            center=_vec3_from(kv.get("CENTER")),
            radius=_f(kv.get("RADIUS"), 1.0),
            mat=mat,
            phi=_f(kv.get("PHI"), PI),
            min_theta=_f(kv.get("MIN_THETA"), 0.0),
            max_theta=_f(kv.get("MAX_THETA"), PI),
        )
    elif obj_type == "PLANE":
        builder.add_plane(_vec3_from(kv.get("POINT")), _vec3_from(kv.get("NORMAL"), (0, 1, 0)), mat)
    elif obj_type == "RECTANGLE":
        builder.add_rect(_vec3_from(kv.get("POINT")), _vec3_from(kv.get("WIDTH"), (1, 0, 0)),
                         _vec3_from(kv.get("HEIGHT"), (0, 1, 0)), mat)
    elif obj_type == "TRIANGLE":
        builder.add_triangle(_vec3_from(kv.get("V0")), _vec3_from(kv.get("V1")),
                             _vec3_from(kv.get("V2")), mat)
    elif obj_type == "DISK":
        builder.add_disk(_vec3_from(kv.get("CENTER")), _vec3_from(kv.get("NORMAL"), (0, 1, 0)),
                         _f(kv.get("RADIUS"), 1.0), mat)
    elif obj_type == "BOX":
        builder.add_box(_f(kv.get("LENGTH"), 1.0), _f(kv.get("HEIGHT"), 1.0),
                        _f(kv.get("WIDTH"), 1.0), mat,
                        location=_vec3_from(kv.get("LOCATION")),
                        scale=_vec3_from(kv.get("SCALE"), (1, 1, 1)),
                        orientation=_vec3_from(kv.get("ORIENTATION")))
    elif obj_type == "OPENCYLINDER":
        ntype = {"OPEN": T.NORMAL_OPEN, "CONVEX": T.NORMAL_CONVEX,
                 "CONCAVE": T.NORMAL_CONCAVE}.get((kv.get("NORMAL_TYPE") or ["OPEN"])[0],
                                                  T.NORMAL_OPEN)
        builder.add_open_cylinder(_f(kv.get("PHI"), PI), mat,
                                  location=_vec3_from(kv.get("LOCATION")),
                                  scale=_vec3_from(kv.get("SCALE"), (1, 1, 1)),
                                  orientation=_vec3_from(kv.get("ORIENTATION")),
                                  normal_type=ntype)
    elif obj_type == "SOLIDCYLINDER":
        builder.add_solid_cylinder(mat, location=_vec3_from(kv.get("LOCATION")),
                                   scale=_vec3_from(kv.get("SCALE"), (1, 1, 1)),
                                   orientation=_vec3_from(kv.get("ORIENTATION")))
    elif obj_type == "TORUS":
        builder.add_torus(_f(kv.get("SWEPT_RADIUS"), 1.0), _f(kv.get("TUBE_RADIUS"), 0.25),
                          _f(kv.get("PHI"), PI), mat,
                          location=_vec3_from(kv.get("LOCATION")),
                          scale=_vec3_from(kv.get("SCALE"), (1, 1, 1)),
                          orientation=_vec3_from(kv.get("ORIENTATION")))
    elif obj_type == "MESH":
        _parse_mesh(builder, kv, mat, search_dirs)


def _ns_to_roughness(ns: float) -> float:
    """Phong exponent -> microfacet roughness (the usual sqrt(2/(Ns+2))
    mapping); clamped away from 0 so Ns=1000 stays a finite lobe."""
    import math

    return max(0.01, math.sqrt(2.0 / (max(ns, 0.0) + 2.0)))


def _mtl_material_name(builder: SceneBuilder, m, base_dir, search_dirs) -> str:
    """Bind an OBJ/MTL material to a scene material — the per-group path
    the reference parses but then discards (loadMTL at
    objloader/objloader.h:487+; the binding itself is commented out "for
    now" at buildscene.h:232-239, so this is a beyond-reference feature
    gated behind `MATERIAL FROM_MTL` in a MESH entry).

    Mapping into the reference's material taxonomy (materials.h:8-25):
    Ke>0 -> EMISSIVE; illum 7 / transmissive -> GLASS(Ni); a name that
    matches a metal preset or illum 3/5 -> METAL/MIRROR (MTL cannot carry
    spectral eta/k, so named presets mirror materials.cpp:5-20); Ks
    significant -> PLASTIC(Kd, Ks, Ns); else MATTE(Kd) — with map_Kd and
    map_bump wired to the texture pipeline (texture.cpp:27-86 analog)."""
    from craytracer_tpu.scene.build import METAL_PRESETS

    name = "mtl:" + (m.name or "__nameless__")
    if name in builder._mat_index:
        return name
    dirs = [base_dir] + list(search_dirs)
    diffuse_tex = _load_texture(builder, m.map_kd, dirs) if m.map_kd else -1
    normal_tex = _load_texture(builder, m.map_bump, dirs) if m.map_bump else -1
    ke = max(m.ke)
    ks = max(m.ks)
    if ke > 0.0:
        builder.add_emissive(name, color=tuple(c / ke for c in m.ke),
                             intensity=float(ke))
    elif m.illum == 7 or (m.d < 1.0 and m.ni != 1.0):
        builder.add_glass(name, roughness=0.0 if m.ns <= 0 else _ns_to_roughness(m.ns),
                          ior_in=m.ni if m.ni > 1.0 else 1.5)
    elif m.name.upper() in METAL_PRESETS:
        builder.add_metal(name, preset=m.name.upper(),
                          roughness=_ns_to_roughness(m.ns))
    elif m.illum in (3, 5):
        builder.add_mirror(name, color=m.ks if ks > 0 else (1.0, 1.0, 1.0))
    elif ks > 0.05:
        builder.add_plastic(name, kd=m.kd, ks=m.ks,
                            roughness=_ns_to_roughness(m.ns),
                            diffuse_tex=diffuse_tex)
    else:
        builder.add_matte(name, color=m.kd, diffuse_tex=diffuse_tex,
                          normal_tex=normal_tex)
    return name


def _parse_mesh(builder: SceneBuilder, kv: dict, mat, search_dirs):
    from craytracer_tpu.io.objloader import compute_vertex_normals, load_obj

    file_name = (kv.get("FILE") or kv.get("FILE_NAME") or [""])[0]
    path = None
    for d in search_dirs:
        p = os.path.join(d, file_name)
        if os.path.exists(p):
            path = p
            break
    if path is None:
        return  # missing mesh files are skipped (the reference errors out)
    smooth = (kv.get("SMOOTH") or ["no"])[0] == "yes"
    shapes, mtl_mats = load_obj(path)
    from_mtl = mat == "FROM_MTL"
    base_dir = os.path.dirname(path)
    for shape in shapes:
        normals = shape.normals
        if smooth and normals is None:
            normals = compute_vertex_normals(shape.positions, shape.indices)
        shape_mat = mat
        if from_mtl:
            m = mtl_mats.get(shape.mat_name)
            shape_mat = (_mtl_material_name(builder, m, base_dir, search_dirs)
                         if m is not None else "__default__")
        builder.add_mesh(
            shape.positions, shape.indices, shape_mat,
            normals=normals, uvs=shape.texcoords, smooth=smooth,
            scaling=_vec3_from(kv.get("SCALING"), (1, 1, 1)),
            location=_vec3_from(kv.get("LOCATION")),
            orientation=_vec3_from(kv.get("ORIENTATION")),
        )


def load_scene_file(path: str, builder: SceneBuilder | None = None,
                    accel: str = "auto"):
    """Parse a scene file -> (Scene, Camera, Film).

    `accel`: triangle accel backend ('auto' | 'none' | 'bvh' | 'grid'),
    the analog of the reference's accel_struct config (config.h:16)."""
    builder, camera, film = parse_scene_file(path, builder)
    return builder.build(accel=accel), camera, film


def parse_scene_file(path: str, builder: SceneBuilder | None = None):
    """Parse a scene file into a populated SceneBuilder (nothing built or
    uploaded yet) -> (SceneBuilder, Camera, Film)."""
    with open(path) as f:
        ts = TokenStream(tokenize(f.read()))
    search_dirs = [os.path.dirname(os.path.abspath(path)), os.getcwd()]
    builder = builder or SceneBuilder()

    # Film/camera defaults (the reference requires a header; cornell_box.txt
    # lacks one, so defaults stand in: 256x256 @ 40deg like its gallery).
    film_kv = dict(WINDOW_WIDTH=256, WINDOW_HEIGHT=256, IMAGE_WIDTH=256,
                   IMAGE_HEIGHT=256, FOV=40.0)
    cam_pos = (0.0, 0.0, 5.0)
    look_point = (0.0, 0.0, 0.0)
    env = None

    while not ts.eof():
        tok = ts.next()
        if tok in ("WINDOW_WIDTH", "WINDOW_HEIGHT", "IMAGE_WIDTH", "IMAGE_HEIGHT"):
            film_kv[tok] = ts.next_int()
        elif tok == "FOV":
            film_kv["FOV"] = ts.next_float()
        elif tok == "CAMERA_POS":
            cam_pos = ts.next_vec3()
        elif tok == "LOOK_POINT":
            look_point = ts.next_vec3()
        elif tok == "MATERIAL":
            mat_type = ts.next()
            kv = _collect_block(ts)
            _parse_material(builder, mat_type, kv, search_dirs)
        elif tok == "END_MATERIALS":
            continue
        elif tok == "OBJECT":
            obj_type = ts.next()
            kv = _collect_block(ts)
            if obj_type in _OBJECT_TYPES:
                _parse_object(builder, obj_type, kv, search_dirs)
        elif tok == "POINT_LIGHT":
            # Deviation: grammar extension. The reference defines PointLight
            # (lights.h:25-34, assignPointLight lights.cpp:28-41) but its
            # scene grammar never instantiates one; this block exposes the
            # existing delta-light support (and the caustic proj map that
            # consumes it) from scene files.
            kv = _collect_block(ts)
            builder.add_point_light(
                _vec3_from(kv.get("POINT")),
                _color_from(kv.get("COLOR"), (1, 1, 1)),
                _f(kv.get("INTENSITY"), 1.0),
                dist_atten=(kv.get("DIST_ATTEN") or ["yes"])[0] != "no")
        elif tok == "DIRECTIONAL_LIGHT":
            # Deviation: grammar extension (DirLight, lights.h:18-23).
            kv = _collect_block(ts)
            builder.add_directional_light(
                _vec3_from(kv.get("DIRECTION"), (0, 1, 0)),
                _color_from(kv.get("COLOR"), (1, 1, 1)),
                _f(kv.get("INTENSITY"), 1.0))
        elif tok == "ENV_LIGHT":
            kv = _collect_block(ts)
            kind = (kv.get("TYPE") or ["CONSTANT"])[0]
            intensity = _f(kv.get("INTENSITY"), 0.0)
            if kind == "TEXTURE":
                tex_file = (kv.get("COLOR") or [""])[0]
                tex_id = _load_texture(builder, tex_file, search_dirs)
                if tex_id >= 0:
                    # reference applies a fixed rot-y(-0.76) to textured env
                    # maps (buildscene.h:516). `IMPORTANCE yes` (grammar
                    # extension) turns on texel-CDF NEE sampling.
                    imp = (kv.get("IMPORTANCE") or ["no"])[0] == "yes"
                    builder.set_env_light("texture", intensity=intensity,
                                          tex_id=tex_id, rotate_y_angle=-0.76,
                                          importance=imp)
                else:
                    builder.set_env_light("constant", (1.0, 1.0, 1.0), intensity)
            else:
                builder.set_env_light("constant", _color_from(kv.get("COLOR"), (1, 1, 1)),
                                      intensity)

    camera = make_camera(cam_pos, look_point)
    import jax.numpy as jnp

    film = Film(
        fov=jnp.float32(math.radians(film_kv["FOV"])),
        width=int(film_kv["IMAGE_WIDTH"]),
        height=int(film_kv["IMAGE_HEIGHT"]),
    )
    return builder, camera, film
