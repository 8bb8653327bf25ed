"""Host-side scene builder: Python API -> flat device SoA arrays.

Replaces the reference's growable pointer stores + preprocessing passes
(`scene/scenedata.h:20-307`, `buildscene.h:567-923`) with a numpy
accumulation phase that emits the `Scene` pytree. All derivations the
reference performs at startup happen here:

* area lights auto-derived from emissive rect/sphere/disk objects
  (initAreaLights, buildscene.h:567-608);
* mesh lights from contiguous emissive triangles with an area CDF
  (initMeshLights, buildscene.h:749-833);
* light power distribution, normalized (preprocessLights,
  buildscene.h:835-923) — including the reference's product-of-components
  "mean" for area-light color (buildscene.h:911-913);
* env-light world radius = 2x scene-bounds diagonal (buildscene.h:839-873).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import jax.numpy as jnp
import numpy as np

from craytracer_tpu.constants import METAL_PRESETS, PI
from craytracer_tpu.scene import types as T


def beckmann_roughness_to_alpha(roughness: float) -> float:
    """BeckmannRoughnessToAlpha (microfacet.h:26-32)."""
    roughness = max(roughness, 1e-3)
    x = math.log(roughness)
    return (
        1.62142
        + 0.819955 * x
        + 0.1734 * x * x
        + 0.0171201 * x**3
        + 0.000640711 * x**4
    )


@dataclass
class _Mat:
    name: str
    mat_type: int
    color: tuple = (0.0, 0.0, 0.0)
    ks: tuple = (0.0, 0.0, 0.0)
    sigma: float = 0.0
    ior_in: float = 1.5
    ior_out: float = 1.0
    cf_in: tuple = (1.0, 1.0, 1.0)
    cf_out: tuple = (1.0, 1.0, 1.0)
    eta: tuple = (1.0, 1.0, 1.0)
    k: tuple = (0.0, 0.0, 0.0)
    alphax: float = 0.0
    alphay: float = 0.0
    distrib: int = T.DIST_BECKMANN
    intensity: float = 0.0
    diffuse_tex: int = -1
    normal_tex: int = -1


def _affine_inverse_rows(location, scale, orientation):
    """Precomposed world->object transform S^-1 R^-1 T^-1 exactly as the
    scene parser builds it (scene/scenefile.h:497-507), plus the normal
    matrix R S^-1 used when pushing object-space normals to world
    (buildscene.h:214-314 convention)."""
    from craytracer_tpu.core.math import euler_to_mat3

    loc = np.asarray(location, np.float64)
    sc = np.asarray(scale, np.float64)
    rot = euler_to_mat3(orientation).astype(np.float64)
    inv_s = np.diag(1.0 / sc)
    inv_r = rot.T
    m3 = inv_s @ inv_r  # upper 3x3 of S^-1 R^-1
    t = m3 @ (-loc)
    inv_transform = np.concatenate([m3, t[:, None]], axis=1)  # [3,4]
    normal_mat = rot @ inv_s  # (M^-1)^T for M = T R S
    return inv_transform.astype(np.float32), normal_mat.astype(np.float32)


class SceneBuilder:
    """Accumulates primitives/materials/lights, then `build()`s the pytree."""

    def __init__(self):
        self._mats: list[_Mat] = []
        self._mat_index: dict[str, int] = {}
        self._spheres = []
        self._planes = []
        self._rects = []
        self._disks = []
        self._triangles = []
        self._bulk_triangles = []  # list of column-array blocks (bulk adds)
        self._instanced = []
        self._env: Optional[dict] = None
        self._textures = []  # list of (np[H,W,3] f32)
        self._tex_index: dict[str, int] = {}
        self._extra_lights = []  # directional/point lights
        self._mesh_light_ranges = []  # (start_tri, end_tri, mat_id)
        self.add_material(_Mat(name="__default__", mat_type=T.MAT_MATTE, color=(0.5, 0.5, 0.5)))

    # -- materials ---------------------------------------------------------

    def add_material(self, mat: _Mat) -> int:
        idx = len(self._mats)
        self._mats.append(mat)
        self._mat_index[mat.name] = idx
        return idx

    def add_matte(self, name, color=(0.5, 0.5, 0.5), sigma=0.0, diffuse_tex=-1, normal_tex=-1):
        return self.add_material(
            _Mat(name=name, mat_type=T.MAT_MATTE, color=tuple(color), sigma=float(sigma),
                 diffuse_tex=diffuse_tex, normal_tex=normal_tex)
        )

    def add_mirror(self, name, color=(1.0, 1.0, 1.0)):
        return self.add_material(_Mat(name=name, mat_type=T.MAT_MIRROR, color=tuple(color)))

    def add_transparent(self, name, ior_in=1.5, ior_out=1.0, cf_in=(1, 1, 1), cf_out=(1, 1, 1)):
        return self.add_material(
            _Mat(name=name, mat_type=T.MAT_TRANSPARENT, ior_in=float(ior_in),
                 ior_out=float(ior_out), cf_in=tuple(cf_in), cf_out=tuple(cf_out))
        )

    def add_emissive(self, name, color=(1.0, 1.0, 1.0), intensity=1.0):
        return self.add_material(
            _Mat(name=name, mat_type=T.MAT_EMISSIVE, color=tuple(color), intensity=float(intensity))
        )

    def add_plastic(self, name, kd=(0.5, 0.5, 0.5), ks=(0.5, 0.5, 0.5), roughness=0.1,
                    diffuse_tex=-1):
        # Plastic FresnelBlendSpecular keeps the raw roughness as alpha
        # (BSDF_addFresnelBlendSpecular, reflection.cpp:945-963).
        return self.add_material(
            _Mat(name=name, mat_type=T.MAT_PLASTIC, color=tuple(kd), ks=tuple(ks),
                 alphax=float(roughness), alphay=float(roughness),
                 ior_in=1.5, ior_out=1.0, diffuse_tex=diffuse_tex)
        )

    def add_glass(self, name, roughness=0.0, ior_in=1.5, ior_out=1.0):
        # Glass maps roughness -> alpha (BSDF_addMicrofacetFresnel,
        # reflection.cpp:916-929).
        a = beckmann_roughness_to_alpha(float(roughness))
        return self.add_material(
            _Mat(name=name, mat_type=T.MAT_GLASS, alphax=a, alphay=a,
                 ior_in=float(ior_in), ior_out=float(ior_out))
        )

    def add_metal(self, name, preset="GOLD", roughness=0.05, eta=None, k=None):
        # Metal keeps raw roughness as alpha (BSDF_addMicrofacetReflectionMetal,
        # reflection.cpp:886-907).
        if eta is None or k is None:
            eta, k = METAL_PRESETS.get(preset.upper(), METAL_PRESETS["GOLD"])
        return self.add_material(
            _Mat(name=name, mat_type=T.MAT_METAL, eta=tuple(eta), k=tuple(k),
                 alphax=float(roughness), alphay=float(roughness))
        )

    def material_id(self, name) -> int:
        if isinstance(name, int):
            return name
        return self._mat_index.get(name, 0)

    def material_type(self, mat_id: int) -> int:
        return self._mats[mat_id].mat_type

    # -- textures ----------------------------------------------------------

    def add_texture(self, name: str, data: np.ndarray) -> int:
        if name in self._tex_index:
            return self._tex_index[name]
        idx = len(self._textures)
        self._textures.append(np.asarray(data, np.float32))
        self._tex_index[name] = idx
        return idx

    # -- primitives --------------------------------------------------------

    def add_sphere(self, center, radius, mat, phi=PI, min_theta=0.0, max_theta=PI):
        self._spheres.append((np.asarray(center, np.float32), float(radius), float(phi),
                              float(min_theta), float(max_theta), self.material_id(mat)))

    def add_plane(self, point, normal, mat):
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self._planes.append((np.asarray(point, np.float32), n.astype(np.float32),
                             self.material_id(mat)))

    def add_rect(self, point, width, height, mat):
        w = np.asarray(width, np.float64)
        h = np.asarray(height, np.float64)
        n = np.cross(w, h)
        n = n / np.linalg.norm(n)
        self._rects.append((np.asarray(point, np.float32), w.astype(np.float32),
                            h.astype(np.float32), n.astype(np.float32), self.material_id(mat)))

    def add_disk(self, center, normal, radius, mat):
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self._disks.append((np.asarray(center, np.float32), n.astype(np.float32),
                            float(radius), self.material_id(mat)))

    def add_triangle(self, v0, v1, v2, mat, n0=None, n1=None, n2=None,
                     uv0=(0, 0), uv1=(0, 0), uv2=(0, 0), smooth=False,
                     double_sided=True):
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        fn = np.cross((v1 - v0).astype(np.float64), (v2 - v0).astype(np.float64))
        norm = np.linalg.norm(fn)
        fn = (fn / norm if norm > 0 else np.array([0.0, 0.0, 1.0])).astype(np.float32)
        n0 = fn if n0 is None else np.asarray(n0, np.float32)
        n1 = fn if n1 is None else np.asarray(n1, np.float32)
        n2 = fn if n2 is None else np.asarray(n2, np.float32)
        self._triangles.append((v0, v1, v2, n0, n1, n2,
                                np.asarray(uv0, np.float32), np.asarray(uv1, np.float32),
                                np.asarray(uv2, np.float32), fn, bool(smooth),
                                bool(double_sided), self.material_id(mat)))

    def add_triangles_array(self, v0, v1, v2, mat, normals=None, uvs=None,
                            smooth=False, double_sided=False):
        """Bulk-add a triangle soup ([T,3] vertex arrays; `normals` is an
        optional ([T,3],[T,3],[T,3]) tuple of per-corner normals, `uvs`
        likewise). Orders of magnitude faster than per-triangle adds for
        San-Miguel-scale meshes."""
        v0 = np.asarray(v0, np.float32).reshape(-1, 3)
        v1 = np.asarray(v1, np.float32).reshape(-1, 3)
        v2 = np.asarray(v2, np.float32).reshape(-1, 3)
        t = v0.shape[0]
        fn = np.cross((v1 - v0).astype(np.float64), (v2 - v0).astype(np.float64))
        lens = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = (fn / np.where(lens > 0, lens, 1.0)).astype(np.float32)
        n0, n1, n2 = (fn, fn, fn) if normals is None else [
            np.asarray(x, np.float32) for x in normals]
        z2 = np.zeros((t, 2), np.float32)
        uv0, uv1, uv2 = (z2, z2, z2) if uvs is None else [
            np.asarray(x, np.float32) for x in uvs]
        mat_id = self.material_id(mat)
        start = self.num_triangles()
        self._bulk_triangles.append((
            v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, fn,
            np.full(t, bool(smooth)), np.full(t, bool(double_sided)),
            np.full(t, mat_id, np.int32),
        ))
        if self._mats[mat_id].mat_type == T.MAT_EMISSIVE:
            self._mesh_light_ranges.append((start, start + t, mat_id))
        return start, start + t

    def num_triangles(self) -> int:
        return len(self._triangles) + sum(b[0].shape[0] for b in self._bulk_triangles)

    def add_mesh(self, positions, indices, mat, normals=None, uvs=None, smooth=False,
                 scaling=(1, 1, 1), location=(0, 0, 0), orientation=(0, 0, 0)):
        """Bake a mesh's triangles into world space (generateMeshTriangles,
        buildscene.h:214-314): verts through T R S, normals through R S^-1."""
        from craytracer_tpu.core.math import euler_to_mat3

        pos = np.asarray(positions, np.float64).reshape(-1, 3)
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        rot = euler_to_mat3(orientation).astype(np.float64)
        sc = np.diag(np.asarray(scaling, np.float64))
        m = rot @ sc
        nm = rot @ np.diag(1.0 / np.asarray(scaling, np.float64))
        world = pos @ m.T + np.asarray(location, np.float64)
        if normals is not None and len(np.asarray(normals)) > 0:
            nrm = np.asarray(normals, np.float64).reshape(-1, 3) @ nm.T
            lens = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.where(lens > 0, lens, 1.0)
        else:
            nrm = None
            smooth = False
        uv = np.asarray(uvs, np.float32).reshape(-1, 2) if uvs is not None and len(np.asarray(uvs)) else None
        start = len(self._triangles)
        mat_id = self.material_id(mat)
        for f in idx:
            tri_v = [world[i].astype(np.float32) for i in f]
            tri_n = [nrm[i].astype(np.float32) for i in f] if nrm is not None else [None] * 3
            tri_uv = [uv[i] for i in f] if uv is not None else [(0, 0)] * 3
            self.add_triangle(tri_v[0], tri_v[1], tri_v[2], mat_id,
                              n0=tri_n[0], n1=tri_n[1], n2=tri_n[2],
                              uv0=tri_uv[0], uv1=tri_uv[1], uv2=tri_uv[2],
                              smooth=smooth, double_sided=False)
        end = len(self._triangles)
        if self._mats[mat_id].mat_type == T.MAT_EMISSIVE:
            self._mesh_light_ranges.append((start, end, mat_id))
        return start, end

    def _add_instanced(self, kind, params, mat, location, scale, orientation,
                       normal_type=T.NORMAL_OPEN):
        inv_t, nmat = _affine_inverse_rows(location, scale, orientation)
        p = np.zeros(4, np.float32)
        p[: len(params)] = params
        self._instanced.append((inv_t, nmat, int(kind), p, int(normal_type),
                                self.material_id(mat)))

    def add_box(self, length, height, width, mat, location=(0, 0, 0), scale=(1, 1, 1),
                orientation=(0, 0, 0)):
        """Axis-aligned box of dims (length, height, width) centered per the
        reference's initBox canonical box (shapes/instanced.cpp)."""
        self._add_instanced(T.INST_AABOX, [length, height, width], mat,
                            location, scale, orientation)

    def add_open_cylinder(self, phi, mat, location=(0, 0, 0), scale=(1, 1, 1),
                          orientation=(0, 0, 0), normal_type=T.NORMAL_OPEN):
        self._add_instanced(T.INST_OPEN_CYLINDER, [phi, 1.0, 1.0], mat,
                            location, scale, orientation, normal_type)

    def add_solid_cylinder(self, mat, location=(0, 0, 0), scale=(1, 1, 1),
                           orientation=(0, 0, 0)):
        """Solid cylinder = open tube + two disk caps (initSolidCylinder,
        shapes/cylinder.cpp:23-60), expanded into three instanced prims."""
        self._add_instanced(T.INST_OPEN_CYLINDER, [PI, 1.0, 1.0], mat,
                            location, scale, orientation, T.NORMAL_CONVEX)
        # caps at y = +-half_height (canonical half-height 1.0, radius 1.0)
        self._add_instanced(T.INST_DISK, [1.0, 1.0, 0.0], mat, location, scale, orientation)
        self._add_instanced(T.INST_DISK, [1.0, -1.0, 0.0], mat, location, scale, orientation)

    def add_torus(self, swept_radius, tube_radius, phi, mat, location=(0, 0, 0),
                  scale=(1, 1, 1), orientation=(0, 0, 0)):
        self._add_instanced(T.INST_TORUS, [swept_radius, tube_radius, phi], mat,
                            location, scale, orientation)

    # -- lights ------------------------------------------------------------

    def add_directional_light(self, toward, color=(1, 1, 1), intensity=1.0):
        """Delta directional light; `toward` points at the light (wi)."""
        self._extra_lights.append((T.LIGHT_DIRECTIONAL, np.asarray(toward, np.float32),
                                   tuple(color), float(intensity), 0.0))

    def add_point_light(self, point, color=(1, 1, 1), intensity=1.0,
                        dist_atten=True):
        """Delta point light; radius slot stores the 1/d^2 attenuation flag
        (PointLight.dist_atten, lights.h:25-34)."""
        self._extra_lights.append((T.LIGHT_POINT, np.asarray(point, np.float32),
                                   tuple(color), float(intensity),
                                   1.0 if dist_atten else 0.0))

    def set_env_light(self, kind, color=(1, 1, 1), intensity=1.0, tex_id=-1,
                      rotate_y_angle=0.0, importance=False):
        """kind: 'constant' or 'texture'. Texture env maps get the reference's
        fixed rot-y(-0.76) transform unless overridden (buildscene.h:516).

        importance=True (texture envs) builds a luminance*sin(theta) texel
        CDF so NEE samples the map instead of the cosine hemisphere — a
        beyond-reference variance reduction for sun/HDR maps; the default
        keeps the reference's cosine sampling (trace.h:272-296)."""
        self._env = dict(kind=kind, color=tuple(color), intensity=float(intensity),
                         tex_id=int(tex_id), rotate_y_angle=float(rotate_y_angle),
                         importance=bool(importance))

    # -- build -------------------------------------------------------------

    def _scene_bounds(self):
        mins = np.full(3, np.inf)
        maxs = np.full(3, -np.inf)

        def cover(p):
            nonlocal mins, maxs
            mins = np.minimum(mins, p)
            maxs = np.maximum(maxs, p)

        for c, r, *_ in self._spheres:
            cover(c - r)
            cover(c + r)
        for p, w, h, n, m in self._rects:
            for q in (p, p + w, p + h, p + w + h):
                cover(q)
        for c, n, r, m in self._disks:
            cover(c - r)
            cover(c + r)
        cols = getattr(self, "_tri_columns", None)
        if cols is not None and cols[0].shape[0] > 0:
            for c in cols[:3]:
                cover(c.min(axis=0))
                cover(c.max(axis=0))
        else:
            for tri in self._triangles:
                for q in tri[:3]:
                    cover(q)
        for inv_t, nmat, kind, p, nt, m in self._instanced:
            # object-space bound of canonical prims is within [-s, s] where s
            # derives from params; conservatively invert the affine on corners.
            m3 = inv_t[:, :3]
            t = inv_t[:, 3]
            fwd = np.linalg.inv(m3)
            if kind == T.INST_AABOX:
                half = np.array([p[0], p[1], p[2]], np.float64) / 2.0
            elif kind == T.INST_TORUS:
                s = p[0] + p[1]
                half = np.array([s, p[1], s], np.float64)
            else:
                half = np.array([1.0, 1.0, 1.0], np.float64)
            for sx in (-1, 1):
                for sy in (-1, 1):
                    for sz in (-1, 1):
                        q = fwd @ (half * [sx, sy, sz] - t)
                        cover(q)
        if not np.all(np.isfinite(mins)):
            mins = np.zeros(3)
            maxs = np.ones(3)
        return mins, maxs

    def build(self, accel: str = "auto", light_power: str = "reference") -> T.Scene:
        """accel: 'none' (brute force), 'bvh', or 'auto' (bvh when the
        triangle count warrants it).
        light_power: 'reference' reproduces preprocessLights exactly
        (product-of-components area "mean", mesh lights at power 0,
        buildscene.h:875-923); 'principled' uses mean(color) * intensity *
        area for every light so mesh lights participate in NEE."""
        self._light_power_mode = light_power
        f32 = np.float32

        def soa(rows, spec):
            if not rows:
                return [np.zeros((0,) + s, d) for s, d in spec]
            cols = list(zip(*rows))
            return [np.asarray(c, dtype=d).reshape((len(rows),) + s)
                    for c, (s, d) in zip(cols, spec)]

        sc, sr, sphi, smin, smax, smat = soa(
            self._spheres, [((3,), f32), ((), f32), ((), f32), ((), f32), ((), f32), ((), np.int32)]
        )
        spheres = T.Spheres(*map(jnp.asarray, (sc, sr, sphi, smin, smax, smat)))

        pp, pn, pm = soa(self._planes, [((3,), f32), ((3,), f32), ((), np.int32)])
        planes = T.Planes(*map(jnp.asarray, (pp, pn, pm)))

        rp, rw, rh, rn, rm = soa(
            self._rects, [((3,), f32), ((3,), f32), ((3,), f32), ((3,), f32), ((), np.int32)]
        )
        rects = T.Rects(*map(jnp.asarray, (rp, rw, rh, rn, rm)))

        dc, dn, dr, dm = soa(self._disks, [((3,), f32), ((3,), f32), ((), f32), ((), np.int32)])
        disks = T.Disks(*map(jnp.asarray, (dc, dn, dr, dm)))

        tv = soa(self._triangles,
                 [((3,), f32)] * 6 + [((2,), f32)] * 3
                 + [((3,), f32), ((), bool), ((), bool), ((), np.int32)])
        if self._bulk_triangles:
            merged = []
            for col in range(13):
                blocks = [tv[col]] + [blk[col] for blk in self._bulk_triangles]
                merged.append(np.concatenate(blocks, axis=0))
            tv = merged
        self._tri_columns = tv  # verts by global index for lights/bounds
        triangles = T.Triangles(*map(jnp.asarray, tv))

        it, inm, ik, ip, int_, im = soa(
            self._instanced,
            [((3, 4), f32), ((3, 3), f32), ((), np.int32), ((4,), f32), ((), np.int32), ((), np.int32)],
        )
        instanced = T.Instanced(*map(jnp.asarray, (it, inm, ik, ip, int_, im)))

        mats = self._mats
        materials = T.Materials(
            mat_type=jnp.asarray([m.mat_type for m in mats], jnp.int32),
            color=jnp.asarray([m.color for m in mats], f32),
            ks=jnp.asarray([m.ks for m in mats], f32),
            sigma=jnp.asarray([m.sigma for m in mats], f32),
            on_a=jnp.asarray([self._on_a(m.sigma) for m in mats], f32),
            on_b=jnp.asarray([self._on_b(m.sigma) for m in mats], f32),
            ior_in=jnp.asarray([m.ior_in for m in mats], f32),
            ior_out=jnp.asarray([m.ior_out for m in mats], f32),
            cf_in=jnp.asarray([m.cf_in for m in mats], f32),
            cf_out=jnp.asarray([m.cf_out for m in mats], f32),
            eta=jnp.asarray([m.eta for m in mats], f32),
            k=jnp.asarray([m.k for m in mats], f32),
            alphax=jnp.asarray([m.alphax for m in mats], f32),
            alphay=jnp.asarray([m.alphay for m in mats], f32),
            distrib=jnp.asarray([m.distrib for m in mats], jnp.int32),
            intensity=jnp.asarray([m.intensity for m in mats], f32),
            diffuse_tex=jnp.asarray([m.diffuse_tex for m in mats], jnp.int32),
            normal_tex=jnp.asarray([m.normal_tex for m in mats], jnp.int32),
        )

        lights, mesh_lights, env = self._build_lights(mats)

        textures = self._build_textures()

        n_tris = tv[0].shape[0]
        accel_requested = accel  # sphere accel keys off the request, not
        # the triangle-count override below
        if accel == "auto":
            # 4-wide BVH: ~half the serial traversal depth of the binary BVH
            accel = "bvh4" if n_tris >= 64 else "none"
        tri_bvh = None
        tri_shadow = None
        tri_cam = None
        if n_tris == 0:
            accel = "none"
        elif accel == "hybrid":
            # bvh4 fat rows for closest-hit (incoherent-robust) + binned
            # treelets for shadow any-hit (see T.Scene.tri_shadow)
            import os

            from craytracer_tpu.accel.binned import build_binned
            from craytracer_tpu.accel.bvh4 import build_bvh4
            from craytracer_tpu.native import _load as _native_load

            split = ("sah" if _native_load() is not None else "median")
            leaf = int(os.environ.get("CRAY_BVH4_LEAF", "2"))
            tri_bvh = build_bvh4(np.asarray(tv[0]), np.asarray(tv[1]),
                                 np.asarray(tv[2]), leaf_size=leaf,
                                 split=split)
            tri_shadow = build_binned(
                np.asarray(tv[0]), np.asarray(tv[1]), np.asarray(tv[2]),
                L=int(os.environ.get("CRAY_BINNED_L", "512")), split=split,
                mxu=os.environ.get("CRAY_BINNED_MXU", "1") == "1")
        elif accel == "bvh":
            from craytracer_tpu.accel.bvh import build_bvh

            tri_bvh = build_bvh(np.asarray(tv[0]), np.asarray(tv[1]), np.asarray(tv[2]))
        elif accel == "bvh4":
            import os

            from craytracer_tpu.accel.bvh4 import build_bvh4

            # leaf_size=2 keeps the fat row at 128 columns (see
            # BVH4Arrays.leaf_size); env-tunable for A/B.
            leaf = int(os.environ.get("CRAY_BVH4_LEAF", "2"))
            # SAH default (hit-identical to median, better trees on
            # irregular scenes); median when the native builder is absent
            # (the numpy fallback only implements the reference's median).
            from craytracer_tpu.native import _load as _native_load

            default_split = "sah" if _native_load() is not None else "median"
            tri_bvh = build_bvh4(np.asarray(tv[0]), np.asarray(tv[1]),
                                 np.asarray(tv[2]), leaf_size=leaf,
                                 split=os.environ.get("CRAY_BVH_SPLIT",
                                                      default_split))
            # Camera-bounce binned table (T.Scene.tri_cam): opt-in while
            # the end-to-end win is being measured (CRAY_CAM_BINNED=1)
            if os.environ.get("CRAY_CAM_BINNED", "0") == "1":
                from craytracer_tpu.accel.binned import build_binned

                tri_cam = build_binned(
                    np.asarray(tv[0]), np.asarray(tv[1]), np.asarray(tv[2]),
                    L=int(os.environ.get("CRAY_BINNED_L", "512")),
                    split=os.environ.get("CRAY_BVH_SPLIT", default_split),
                    mxu=os.environ.get("CRAY_BINNED_MXU", "1") == "1")
        elif accel == "bvh4q":
            import os

            from craytracer_tpu.accel.bvh4q import build_bvh4q

            leaf = int(os.environ.get("CRAY_BVH4_LEAF", "2"))
            tri_bvh = build_bvh4q(np.asarray(tv[0]), np.asarray(tv[1]),
                                  np.asarray(tv[2]), leaf_size=leaf)
        elif accel == "binned":
            import os

            from craytracer_tpu.accel.binned import build_binned
            from craytracer_tpu.native import _load as _native_load

            # gather-free treelet traversal (accel/binned.py); pairs with
            # the renderer's Morton pixel order for block coherence
            tri_bvh = build_binned(
                np.asarray(tv[0]), np.asarray(tv[1]), np.asarray(tv[2]),
                L=int(os.environ.get("CRAY_BINNED_L", "512")),
                split=("sah" if _native_load() is not None else "median"),
                mxu=os.environ.get("CRAY_BINNED_MXU", "1") == "1")
        elif accel == "grid":
            from craytracer_tpu.accel.grid import build_grid

            tri_bvh = build_grid(np.asarray(tv[0]), np.asarray(tv[1]), np.asarray(tv[2]))

        sph_bvh = None
        if accel_requested != "none" and spheres.mat_id.shape[0] >= 256:
            # sphere-heavy scene: index analytic spheres too (the
            # reference's accelerators hold every object type)
            from craytracer_tpu.accel.bvh4_sphere import build_bvh4_spheres

            import os

            sph_bvh = build_bvh4_spheres(
                np.asarray(spheres.center), np.asarray(spheres.radius),
                np.asarray(spheres.phi), np.asarray(spheres.min_theta),
                np.asarray(spheres.max_theta),
                leaf_size=int(os.environ.get("CRAY_BVH4_LEAF", "2")))

        from craytracer_tpu.ops.gather import validate_int_tables

        validate_int_tables(
            materials.mat_type, materials.distrib, materials.diffuse_tex,
            materials.normal_tex, lights.light_type, lights.mesh_light_id,
            triangles.mat_id)
        return T.Scene(
            spheres=spheres, planes=planes, rects=rects, disks=disks,
            triangles=triangles, instanced=instanced, materials=materials,
            lights=lights, mesh_lights=mesh_lights, env=env, textures=textures,
            tri_bvh=tri_bvh, tri_shadow=tri_shadow,
            tri_cam=tri_cam,
            sph_bvh=sph_bvh, accel=accel,
            mat_types_present=tuple(sorted(
                int(t) for t in np.unique(np.asarray(materials.mat_type)))),
            light_types_present=tuple(sorted(
                int(t) for t in np.unique(np.asarray(lights.light_type)))),
            matte_lambertian=bool(
                np.all(np.asarray(materials.on_b)[
                    np.asarray(materials.mat_type) == T.MAT_MATTE] == 0.0)),
        )

    @staticmethod
    def _on_a(sigma_deg):
        s = math.radians(sigma_deg)
        s2 = s * s
        return 1.0 - s2 / (2.0 * (s2 + 0.33))

    @staticmethod
    def _on_b(sigma_deg):
        s = math.radians(sigma_deg)
        s2 = s * s
        return 0.45 * s2 / (s2 + 0.09)

    def _build_textures(self) -> T.TexturePack:
        if not self._textures:
            return T.empty_texture_pack()
        offsets, flats, ws, hs = [], [], [], []
        cursor = 0
        for tex in self._textures:
            h, w = tex.shape[0], tex.shape[1]
            offsets.append(cursor)
            ws.append(w)
            hs.append(h)
            flats.append(tex.reshape(-1, 3))
            cursor += h * w
        return T.TexturePack(
            texels=jnp.asarray(np.concatenate(flats, axis=0)),
            offset=jnp.asarray(offsets, jnp.int32),
            width=jnp.asarray(ws, jnp.int32),
            height=jnp.asarray(hs, jnp.int32),
        )

    def _build_lights(self, mats):
        f32 = np.float32
        rows = []  # (type, p0, v1, v2, normal, radius, color, intensity,
        #              area, mesh_id, src_group, src_prim)

        def emissive(mat_id):
            m = mats[mat_id]
            return m.mat_type == T.MAT_EMISSIVE, m.color, m.intensity

        for i, (p, w, h, n, mat_id) in enumerate(self._rects):
            is_e, color, inten = emissive(mat_id)
            if is_e:
                area = float(np.linalg.norm(w) * np.linalg.norm(h))
                rows.append((T.LIGHT_AREA_RECT, p, w, h, n, 0.0, color, inten, area, -1,
                             T.GROUP_RECT, i))
        for i, (c, r, phi, mn, mx, mat_id) in enumerate(self._spheres):
            is_e, color, inten = emissive(mat_id)
            if is_e:
                area = float(4.0 * PI * r * r)
                rows.append((T.LIGHT_AREA_SPHERE, c, np.zeros(3, f32), np.zeros(3, f32),
                             np.zeros(3, f32), r, color, inten, area, -1,
                             T.GROUP_SPHERE, i))
        for i, (c, n, r, mat_id) in enumerate(self._disks):
            is_e, color, inten = emissive(mat_id)
            if is_e:
                area = float(PI * r * r)
                rows.append((T.LIGHT_AREA_DISK, c, np.zeros(3, f32), np.zeros(3, f32),
                             n, r, color, inten, area, -1, T.GROUP_DISK, i))

        # Mesh lights: contiguous emissive triangle ranges.
        ml_tri, ml_cdf, ml_off, ml_area = [], [], [0], []
        cols = getattr(self, "_tri_columns", None)
        for k, (start, end, mat_id) in enumerate(self._mesh_light_ranges):
            _, color, inten = emissive(mat_id)
            if cols is not None:
                V0 = cols[0][start:end]
                V1 = cols[1][start:end]
                V2 = cols[2][start:end]
            else:
                V0 = np.stack([self._triangles[t][0] for t in range(start, end)])
                V1 = np.stack([self._triangles[t][1] for t in range(start, end)])
                V2 = np.stack([self._triangles[t][2] for t in range(start, end)])
            areas = (0.5 * np.linalg.norm(np.cross(V1 - V0, V2 - V0), axis=-1)).tolist()
            ml_tri.extend(range(start, end))
            total = sum(areas) or 1.0
            cdf = np.cumsum(areas) / total
            ml_cdf.extend(cdf.tolist())
            ml_off.append(len(ml_tri))
            ml_area.append(total)
            rows.append((T.LIGHT_MESH, np.zeros(3, f32), np.zeros(3, f32), np.zeros(3, f32),
                         np.zeros(3, f32), 0.0, color, inten, total, k, -1, -1))

        # Delta lights (directional/point). The reference's preprocessLights
        # ignores these types (power stays 0, buildscene.h:878-918) because
        # its scene grammar cannot create them; since ours can, they get a
        # sane power = mean(color) * intensity so PATHTRACE NEE can pick
        # them (documented deviation).
        for ltype, p0, color, inten, flag in self._extra_lights:
            rows.append((ltype, p0, np.zeros(3, f32), np.zeros(3, f32),
                         np.zeros(3, f32), flag, color, inten,
                         float(np.mean(color) * inten), -1, -1, -1))

        # Env light (registered as a selectable light only if intensity > 0,
        # buildscene.h:528-538).
        env_cfg = self._env
        mins, maxs = self._scene_bounds()
        world_radius = float(2.0 * np.linalg.norm(maxs - mins))
        if env_cfg is not None and env_cfg["intensity"] > 0.0:
            rows.append((T.LIGHT_ENV, np.zeros(3, f32), np.zeros(3, f32), np.zeros(3, f32),
                         np.zeros(3, f32), 0.0, env_cfg["color"], env_cfg["intensity"],
                         world_radius, -1, -1, -1))

        # Power per light (preprocessLights, buildscene.h:884-923). The
        # reference's area-light "mean" is the product of color components /3
        # (buildscene.h:911) — preserved for estimator parity.
        powers = []
        for row in rows:
            ltype, _, _, _, _, radius, color, inten, area = row[:9]
            c = np.asarray(color, np.float64)
            principled = getattr(self, "_light_power_mode", "reference") == "principled"
            if ltype == T.LIGHT_ENV:
                powers.append(float(c.mean() * inten * world_radius))
            elif ltype in (T.LIGHT_DIRECTIONAL, T.LIGHT_POINT):
                powers.append(float(c.mean() * inten))
            elif ltype == T.LIGHT_MESH and not principled:
                # preprocessLights leaves mesh lights at power 0 (its switch
                # covers only ENVLIGHT/AREALIGHT, buildscene.h:878-918), so
                # they are never NEE-picked — emissive hits only.
                powers.append(0.0)
            elif principled:
                powers.append(float(c.mean() * inten * area))
            else:
                powers.append(float((c[0] * c[1] * c[2]) / 3.0 * inten * area))
        total_p = sum(powers)
        if total_p <= 0.0 and rows:
            powers = [1.0 / len(rows)] * len(rows)
        elif rows:
            powers = [p / total_p for p in powers]

        L = len(rows)
        lights = T.Lights(
            light_type=jnp.asarray([r[0] for r in rows], jnp.int32).reshape(L),
            p0=jnp.asarray(np.array([r[1] for r in rows], f32).reshape(L, 3)),
            v1=jnp.asarray(np.array([r[2] for r in rows], f32).reshape(L, 3)),
            v2=jnp.asarray(np.array([r[3] for r in rows], f32).reshape(L, 3)),
            normal=jnp.asarray(np.array([r[4] for r in rows], f32).reshape(L, 3)),
            radius=jnp.asarray([r[5] for r in rows], f32).reshape(L),
            color=jnp.asarray(np.array([r[6] for r in rows], f32).reshape(L, 3)),
            intensity=jnp.asarray([r[7] for r in rows], f32).reshape(L),
            power=jnp.asarray(powers, f32).reshape(L),
            power_cdf=jnp.asarray(np.cumsum(powers, dtype=np.float64), f32).reshape(L),
            mesh_light_id=jnp.asarray([r[9] for r in rows], jnp.int32).reshape(L),
            src_group=jnp.asarray([r[10] for r in rows], jnp.int32).reshape(L),
            src_prim=jnp.asarray([r[11] for r in rows], jnp.int32).reshape(L),
        )

        n_scene_tris = cols[0].shape[0] if cols is not None else len(self._triangles)
        tri_light_id = np.full(max(n_scene_tris, 1), -1, np.int32)
        for row_idx, row in enumerate(rows):
            if row[0] == T.LIGHT_MESH:
                k = row[9]
                start, end, _ = self._mesh_light_ranges[k]
                tri_light_id[start:end] = row_idx
        mesh_lights = T.MeshLights(
            tri_index=jnp.asarray(ml_tri, jnp.int32).reshape(len(ml_tri)),
            cdf=jnp.asarray(ml_cdf, f32).reshape(len(ml_cdf)),
            light_offset=jnp.asarray(ml_off, jnp.int32),
            surface_area=jnp.asarray(ml_area, f32).reshape(len(ml_area)),
            tri_light_id=jnp.asarray(tri_light_id),
        )

        if env_cfg is None:
            env = T.EnvLight(
                color=jnp.zeros(3, jnp.float32), intensity=jnp.float32(0.0),
                transform=jnp.eye(3, dtype=jnp.float32), world_radius=jnp.float32(world_radius),
                tex_id=jnp.int32(-1), kind=0,
            )
        else:
            from craytracer_tpu.core.math import rotate_y

            kind = 1 if env_cfg["kind"] == "constant" else 2
            transform = (
                rotate_y(env_cfg["rotate_y_angle"]) if env_cfg["rotate_y_angle"] != 0.0
                else jnp.eye(3, dtype=jnp.float32)
            )
            imp = dict(flat_cdf=None, flat_pdf=None, importance=0,
                       imp_h=0, imp_w=0)
            # The CDF is built for EVERY texture env (cheap, host-side):
            # the Renderer defaults importance ON for the principled
            # estimators (physical/mis) even when the scene didn't ask —
            # see integrator/render.py — so the tables must exist.
            # env.importance itself stays as authored (the reference
            # estimator keeps the reference's cosine strategy for parity).
            if (kind == 2
                    and 0 <= env_cfg["tex_id"] < len(self._textures)):
                tex = np.asarray(self._textures[env_cfg["tex_id"]],
                                 np.float64)
                h, w = tex.shape[0], tex.shape[1]
                # EXR texels may be negative (legal); clamp before the
                # luminance mean or the CDF goes non-monotone and
                # searchsorted sampling breaks.
                lum = np.maximum(tex, 0.0).mean(axis=-1)
                # Row solid-angle weight under the REFERENCE texel
                # addressing (getTexColor round-half + v flip): image row
                # r's footprint is theta in pi*[1-(r+.5)/h, 1-(r-.5)/h],
                # whose integral of sin is cos(pi(r-.5)/h)-cos(pi(r+.5)/h)
                # — a band centered at pi*r/h, NOT (r+.5)/h. Row 0 is the
                # wrap row (vf % h): it owns BOTH pole slivers, each
                # 1-cos(.5pi/h).
                r = np.arange(h)
                dcos = (np.cos(np.pi * (r - 0.5) / h)
                        - np.cos(np.pi * (r + 0.5) / h))
                dcos[0] = 2.0 * (1.0 - np.cos(0.5 * np.pi / h))
                lum = lum * dcos[:, None]
                p = (lum / max(lum.sum(), 1e-30)).reshape(-1)
                imp = dict(flat_cdf=jnp.asarray(np.cumsum(p), jnp.float32),
                           flat_pdf=jnp.asarray(p, jnp.float32),
                           importance=1 if env_cfg.get("importance") else 0,
                           imp_h=h, imp_w=w)
            env = T.EnvLight(
                color=jnp.asarray(env_cfg["color"], jnp.float32),
                intensity=jnp.float32(env_cfg["intensity"]),
                transform=transform,
                world_radius=jnp.float32(world_radius),
                tex_id=jnp.int32(env_cfg["tex_id"]),
                kind=kind,
                **imp,
            )
        return lights, mesh_lights, env
