"""Flat SoA scene pytrees — the batched replacement for the reference's
pointer-based tagged-union scene graph (`scene/scenedata.h:20-307`,
`shapes/objecttype.h:19-23`).

Every primitive family is a struct-of-arrays over HBM; a hit is addressed by
(group, index) instead of a `void*`. Materials are a flat parameter table
indexed by `mat_id` — the per-hit BSDF "factory" (`materials.cpp:111-188`)
becomes a gather over these arrays, and every array here is a differentiable
leaf for inverse rendering.
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax.numpy as jnp

# Material type codes (compact re-encoding of materials.h:8-18).
MAT_INVALID = 0
MAT_MATTE = 1
MAT_MIRROR = 2
MAT_TRANSPARENT = 3
MAT_EMISSIVE = 4
MAT_PLASTIC = 5
MAT_GLASS = 6
MAT_METAL = 7

# Microfacet distribution codes (microfacet.h:4-8).
DIST_BECKMANN = 0
DIST_TROWBRIDGE_REITZ = 1

# Instanced-primitive kinds (canonical shapes wrapped by an inverse
# transform, shapes/instanced.h + shapes/generic.cpp).
INST_AABOX = 0
INST_OPEN_CYLINDER = 1
INST_TORUS = 2
INST_DISK = 3  # caps of solid cylinders

# Cylinder normal handling (shapes/instanced.h NormalType).
NORMAL_OPEN = 0
NORMAL_CONVEX = 1
NORMAL_CONCAVE = 2

# Light type codes (lights.h:9-16 re-encoded; area lights carry their
# geometry inline instead of pointing at scene objects).
LIGHT_AREA_RECT = 0
LIGHT_AREA_SPHERE = 1
LIGHT_AREA_DISK = 2
LIGHT_ENV = 3
LIGHT_MESH = 4
LIGHT_DIRECTIONAL = 5
LIGHT_POINT = 6

# Geometry group ids used in hit records.
GROUP_NONE = -1
GROUP_SPHERE = 0
GROUP_PLANE = 1
GROUP_RECT = 2
GROUP_DISK = 3
GROUP_TRIANGLE = 4
GROUP_INSTANCED = 5


@struct.dataclass
class Spheres:
    """Partial spheres (theta/phi clipped), shapes/sphere.h."""

    center: jnp.ndarray  # [N, 3]
    radius: jnp.ndarray  # [N]
    phi: jnp.ndarray  # [N] max |phi|
    min_theta: jnp.ndarray  # [N]
    max_theta: jnp.ndarray  # [N]
    mat_id: jnp.ndarray  # [N] int32


@struct.dataclass
class Planes:
    point: jnp.ndarray  # [N, 3]
    normal: jnp.ndarray  # [N, 3]
    mat_id: jnp.ndarray  # [N]


@struct.dataclass
class Rects:
    point: jnp.ndarray  # [N, 3]
    width: jnp.ndarray  # [N, 3] edge vector
    height: jnp.ndarray  # [N, 3] edge vector
    normal: jnp.ndarray  # [N, 3] normalize(width x height)
    mat_id: jnp.ndarray  # [N]


@struct.dataclass
class Disks:
    center: jnp.ndarray  # [N, 3]
    normal: jnp.ndarray  # [N, 3]
    radius: jnp.ndarray  # [N]
    mat_id: jnp.ndarray  # [N]


@struct.dataclass
class Triangles:
    """World-space-baked triangles: standalone (shapes/triangle.h) and mesh
    triangles (FlatTriangle/SmoothTriangle, shapes/triangle.h:24-40) share one
    SoA; smooth shading interpolates vertex normals where `smooth` is set."""

    v0: jnp.ndarray  # [N, 3]
    v1: jnp.ndarray  # [N, 3]
    v2: jnp.ndarray  # [N, 3]
    n0: jnp.ndarray  # [N, 3] vertex normals (face normal when flat)
    n1: jnp.ndarray  # [N, 3]
    n2: jnp.ndarray  # [N, 3]
    uv0: jnp.ndarray  # [N, 2]
    uv1: jnp.ndarray  # [N, 2]
    uv2: jnp.ndarray  # [N, 2]
    face_normal: jnp.ndarray  # [N, 3]
    smooth: jnp.ndarray  # [N] bool
    double_sided: jnp.ndarray  # [N] bool: standalone triangles face the ray
    # (rayIntersectTriangle flips toward wo, shapes/triangle.cpp:155-168;
    # mesh FlatTriangles do not, shapes/triangle.cpp:186-210)
    mat_id: jnp.ndarray  # [N]


@struct.dataclass
class Instanced:
    """Canonical primitives behind an inverse object-to-world transform
    (shapes/instanced.cpp:48-105): rays are pulled into object space, normals
    pushed out through the inverse-transpose."""

    inv_transform: jnp.ndarray  # [N, 3, 4] world->object affine
    normal_mat: jnp.ndarray  # [N, 3, 3] (M^-1)^T upper block for normals
    kind: jnp.ndarray  # [N] int32 INST_*
    params: jnp.ndarray  # [N, 4] per-kind params (see ops/intersect.py)
    normal_type: jnp.ndarray  # [N] int32 NORMAL_* (cylinders)
    mat_id: jnp.ndarray  # [N]


@struct.dataclass
class Materials:
    """Flat material table (mat_id indexes every array).

    Re-encoding of the 7 material structs (materials.h:27-74). alphax/alphay
    are pre-mapped through BeckmannRoughnessToAlpha where the reference does
    so at BSDF-build time (reflection.cpp:869-1000)."""

    mat_type: jnp.ndarray  # [M] int32
    color: jnp.ndarray  # [M, 3] matte color / mirror cr / emissive color / plastic kd
    ks: jnp.ndarray  # [M, 3] plastic specular
    sigma: jnp.ndarray  # [M] Oren-Nayar sigma (degrees, as parsed)
    on_a: jnp.ndarray  # [M] precomputed Oren-Nayar A
    on_b: jnp.ndarray  # [M] precomputed Oren-Nayar B
    ior_in: jnp.ndarray  # [M]
    ior_out: jnp.ndarray  # [M]
    cf_in: jnp.ndarray  # [M, 3] transparent filter colors
    cf_out: jnp.ndarray  # [M, 3]
    eta: jnp.ndarray  # [M, 3] conductor eta
    k: jnp.ndarray  # [M, 3] conductor k
    alphax: jnp.ndarray  # [M] microfacet alpha (already roughness-mapped)
    alphay: jnp.ndarray  # [M]
    distrib: jnp.ndarray  # [M] int32 DIST_*
    intensity: jnp.ndarray  # [M] emissive scale
    diffuse_tex: jnp.ndarray  # [M] int32 texture id or -1
    normal_tex: jnp.ndarray  # [M] int32 texture id or -1


@struct.dataclass
class Lights:
    """Flat light table with inline geometry + normalized power CDF
    (preprocessLights, buildscene.h:835-923)."""

    light_type: jnp.ndarray  # [L] int32
    p0: jnp.ndarray  # [L, 3] rect point / sphere center / disk center / direction
    v1: jnp.ndarray  # [L, 3] rect width edge
    v2: jnp.ndarray  # [L, 3] rect height edge
    normal: jnp.ndarray  # [L, 3] rect/disk normal
    radius: jnp.ndarray  # [L] sphere/disk radius
    color: jnp.ndarray  # [L, 3]
    intensity: jnp.ndarray  # [L]
    power: jnp.ndarray  # [L] normalized selection probabilities
    power_cdf: jnp.ndarray  # [L] inclusive prefix sum of power
    mesh_light_id: jnp.ndarray  # [L] int32 index into mesh-light tables or -1
    src_group: jnp.ndarray  # [L] GROUP_* of the emissive prim (-1 for env/delta)
    src_prim: jnp.ndarray  # [L] index within that group (MIS back-reference)


@struct.dataclass
class MeshLights:
    """Emissive-triangle soup lights (lights.h:70-80): per-light CDF over
    triangle areas, sampled with searchsorted + uniform barycentrics."""

    tri_index: jnp.ndarray  # [T] int32 index into Triangles
    cdf: jnp.ndarray  # [T] normalized per-light inclusive area CDF
    light_offset: jnp.ndarray  # [K+1] int32 CSR offsets per mesh light
    surface_area: jnp.ndarray  # [K]
    tri_light_id: jnp.ndarray  # [num_scene_triangles] int32 light row or -1
    # (MIS back-reference: which Lights row an emissive triangle belongs to)


@struct.dataclass
class EnvLight:
    """Environment light (lights.h:51-60). `kind` is static: 0 none,
    1 constant, 2 texture."""

    color: jnp.ndarray  # [3]
    intensity: jnp.ndarray  # scalar
    transform: jnp.ndarray  # [3, 3] direction transform (identity or rot-y)
    world_radius: jnp.ndarray  # scalar, set by preprocess (2x scene diagonal)
    tex_id: jnp.ndarray  # int32
    kind: int = struct.field(pytree_node=False, default=0)
    # Texel importance sampling (beyond-reference, opt-in via
    # set_env_light(importance=True) / scene-file `IMPORTANCE yes`):
    # flat_cdf/flat_pdf are the luminance*sin(theta) distribution over the
    # lat-long texel grid (row-major [H*W]); imp_h/imp_w static dims.
    flat_cdf: jnp.ndarray = None  # [H*W] inclusive cumsum, or None
    flat_pdf: jnp.ndarray = None  # [H*W] texel probabilities, or None
    importance: int = struct.field(pytree_node=False, default=0)
    imp_h: int = struct.field(pytree_node=False, default=0)
    imp_w: int = struct.field(pytree_node=False, default=0)


@struct.dataclass
class TexturePack:
    """All textures packed into one flat texel pool + a descriptor table, so
    a single gather serves every texture lookup (reference: per-texture
    malloc'd bitmaps, texture.cpp:6-26)."""

    texels: jnp.ndarray  # [T, 3] f32 in [0,1] (or HDR for EXR)
    offset: jnp.ndarray  # [K] int32 start index into texels
    width: jnp.ndarray  # [K] int32
    height: jnp.ndarray  # [K] int32


def empty_texture_pack() -> TexturePack:
    return TexturePack(
        texels=jnp.zeros((1, 3), jnp.float32),
        offset=jnp.zeros((1,), jnp.int32),
        width=jnp.ones((1,), jnp.int32),
        height=jnp.ones((1,), jnp.int32),
    )


@struct.dataclass
class Scene:
    """The whole differentiable scene as one pytree.

    `accel` selects the triangle intersection backend statically
    ('none' = brute force, 'bvh' = flattened-BVH traversal), mirroring the
    reference's accel_struct config switch (intersect.h:365-440)."""

    spheres: Spheres
    planes: Planes
    rects: Rects
    disks: Disks
    triangles: Triangles
    instanced: Instanced
    materials: Materials
    lights: Lights
    mesh_lights: MeshLights
    env: EnvLight
    textures: TexturePack
    tri_bvh: object = None  # BVHArrays when accel == 'bvh'
    # Hybrid shadow accel (accel == 'hybrid'): BinnedArrays consumed ONLY
    # by shadow_distance — any-hit retire-on-occlusion + max_dist pruning
    # fit the binned block-sync design, while closest-hit bounce rays stay
    # on the fat-row BVH4 (incoherent-robust).
    tri_shadow: object = None
    # Camera-bounce closest-hit accel (CRAY_CAM_BINNED=1): BinnedArrays
    # consumed ONLY for bounce-0 rays, which are Morton-tiled camera
    # bundles — the binned treelet traversal's best case — while
    # bounce>=1 rays stay on the fat-row BVH4.
    tri_cam: object = None
    # Sphere acceleration (analytic primitives indexed like the reference's
    # grid/BVH hold all object types, scene/scenedata.h:12-18): built for
    # sphere-heavy scenes, None = brute force.
    sph_bvh: object = None
    accel: str = struct.field(pytree_node=False, default="none")
    # Static set of MAT_* codes present in the material table, filled by
    # SceneBuilder. jit specializes on it: absent material types cost zero
    # lobe evaluations in the BSDF stage (bsdf/bxdf.py `present`). Empty
    # tuple = unknown -> evaluate everything.
    mat_types_present: tuple = struct.field(pytree_node=False, default=())
    # Static set of LIGHT_* codes present in the light table — the light-
    # sampling analog of mat_types_present: absent light types cost zero
    # sampling work (lights/lights.py). Empty tuple = unknown -> all types.
    light_types_present: tuple = struct.field(pytree_node=False, default=())
    # True when every MATTE material has sigma == 0: the Oren-Nayar lobe
    # degenerates exactly to Lambertian and its trig (4 divides, 2 sqrt per
    # lane per eval) compiles away (bsdf/bxdf.py _oren_nayar_f).
    matte_lambertian: bool = struct.field(pytree_node=False, default=False)

    @property
    def num_lights(self) -> int:
        return self.lights.light_type.shape[0]
