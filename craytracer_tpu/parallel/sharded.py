"""Multi-device / multi-host execution: the data-parallel replacement for
the reference's pthread pixel-job pool (parallel.h:5-62, main.cpp:88-149).

Decomposition (SURVEY.md §2 parallelism table):
* forward rendering is data-parallel over rays: `shard_map` over a 1-D
  device mesh with the pixel batch sharded and the scene replicated — the
  exact analog of "threads pull disjoint pixel ranges against a shared
  read-only scene", with zero collectives in the forward pass;
* the backward (inverse-rendering) pass introduces the only true
  collective: `psum` of parameter gradients (materials / lights / textures /
  camera) across the mesh — the analog the reference never had.

Multi-host: `jax.distributed.initialize()` + the same code; the mesh spans
all processes' devices and XLA routes the psum over the device links
(NVLink within a host).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from craytracer_tpu.camera import Camera, Film
from craytracer_tpu.integrator.wavefront import render_sample
from craytracer_tpu.scene.types import Scene

RAY_AXIS = "rays"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (RAY_AXIS,))


def sharded_render_pass(mesh: Mesh, max_depth: int,
                        estimator: str = "reference",
                        fast_shade=False, interpret: bool = False):
    """Build a jitted pass: (scene, camera, film, pixel_ids, seed, spp) ->
    per-pixel radiance, with pixel_ids sharded over the ray axis and the
    scene/camera replicated. `fast_shade` forwards the path choice (False
    or "bounce", integrator/pallas_shade.production_fast_shade) — the
    megakernel is shard-local (no collectives), so it composes with the
    ray sharding unchanged. `interpret` as in render_sample."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(RAY_AXIS), P(), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    def _shard(scene, camera, film, pixel_ids, seed, spp_index):
        return render_sample(scene, camera, film, pixel_ids, seed, spp_index,
                             max_depth, estimator, fast_shade=fast_shade,
                             interpret=interpret)

    return jax.jit(_shard)


def _render_loss(scene: Scene, camera: Camera, film: Film, pixel_ids, seed,
                 spp_index, target, max_depth: int):
    img = render_sample(scene, camera, film, pixel_ids, seed, spp_index,
                        max_depth, estimator="physical")
    err = img - target
    # local mean; caller psums across shards
    return jnp.mean(err * err)


def sharded_train_step(mesh: Mesh, max_depth: int):
    """Build the jitted inverse-rendering step: forward render + MSE loss
    against a target image + gradients w.r.t. every differentiable scene
    leaf (material/light/texture tables), all-reduced with `psum` over the
    ray axis (SURVEY.md §5.8)."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(RAY_AXIS), P(), P(), P(RAY_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _step(scene, camera, film, pixel_ids, seed, spp_index, target):
        loss, grads = jax.value_and_grad(_render_loss, allow_int=True)(
            scene, camera, film, pixel_ids, seed, spp_index, target, max_depth
        )
        loss = jax.lax.pmean(loss, RAY_AXIS)

        def reduce(g):
            # int leaves (type codes, texture ids) carry float0 tangents —
            # nothing to all-reduce for those.
            if g.dtype == jax.dtypes.float0:
                return g
            return jax.lax.pmean(g, RAY_AXIS)

        grads = jax.tree.map(reduce, grads)
        return loss, grads

    return jax.jit(_step)
