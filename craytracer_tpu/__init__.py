"""craytracer_tpu — a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
CPU path tracer `entropian/CRaytracer` (see SURVEY.md): physically-based path
tracing with next-event estimation, the full analytic primitive set plus
triangle meshes with instancing, uniform-grid / BVH acceleration, a PBRT-style
BxDF library, textures and environment lighting, reference-compatible scene
files, progressive rendering with checkpoint/resume — all expressed as batched
SoA wavefront stages over ray queues so that every hot loop is a single fused
XLA/Pallas program over `[N]`-shaped arrays instead of a per-ray recursion.

Layer map (mirrors SURVEY.md §1, re-designed for batched accelerators):
  core/        L0 math substrate (vec ops on [..., 3] arrays, root solvers, AABB)
  sampling/    L7 samplers (counter-based threefry RNG, disk/hemisphere maps)
  camera.py    L7 camera + film (pinhole, thin-lens)
  scene/       L8 scene model: flat SoA pytrees + builder
  io/          L8/L9 scene-file / OBJ / config parsing, image + state IO
  ops/         L1/L3 batched ray-primitive intersection kernels
  bsdf/        L4 materials, microfacet distributions, vectorized BSDF eval
  lights/      L5 light tables, NEE sampling
  accel/       L2 uniform grid + BVH build & traversal
  integrator/  L6 wavefront path-tracing loop, progressive renderer
  parallel/    multi-device/multi-host sharding (mesh + shard_map)
  utils/       tone mapping, metrics
"""

__version__ = "0.1.0"

from craytracer_tpu.scene.types import Scene  # noqa: F401
