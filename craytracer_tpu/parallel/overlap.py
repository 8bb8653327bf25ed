"""Per-bounce gradient buckets overlapped with the backward wavefront.

SURVEY.md §5.8 / BASELINE north star: `sharded_train_step` issues ONE
tree-wide `pmean` after the whole backward pass — correct, but the
cross-device reduction starts only when every gradient is ready, so the
device links sit idle through the backward sweep and compute sits idle through the
reduce. The bucketed variant here wraps the scene's float leaves in a
custom-VJP identity *per bounce* of an unrolled wavefront: each bounce's
parameter-gradient contribution is all-reduced the moment that bounce's
backward segment produces it, letting XLA schedule collectives concurrently
with the remaining backward compute (the classic DDP bucket strategy, here
keyed to wavefront stages instead of layers).

Correctness: grad = sum_b g_b and pmean is linear, so
sum_b pmean(g_b) == pmean(sum_b g_b) exactly (up to fp reassociation).
`tests/test_overlap.py` asserts allclose against the single-pmean step.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from craytracer_tpu.integrator.wavefront import (_init_state,
                                                 _make_bounce_step)
from craytracer_tpu.parallel.sharded import RAY_AXIS


@jax.custom_vjp
def _pmean_grad(x):
    """Identity whose cotangent is all-reduced over the ray axis."""
    return x


def _pmean_grad_fwd(x):
    return x, None


def _pmean_grad_bwd(_, g):
    return (jax.lax.pmean(g, RAY_AXIS),)


_pmean_grad.defvjp(_pmean_grad_fwd, _pmean_grad_bwd)


def _bucket_scene(scene):
    """Wrap every inexact leaf so its per-bounce gradient contribution is
    pmean'd inside the backward sweep (ints/bools pass through)."""

    def wrap(leaf):
        if isinstance(leaf, jnp.ndarray) and jnp.issubdtype(leaf.dtype, jnp.inexact):
            return _pmean_grad(leaf)
        return leaf

    return jax.tree.map(wrap, scene)


def trace_paths_bucketed(scene, origin, direction, seed, pixel_ids,
                         spp_index, max_depth: int, rr_start: int = 3):
    """Unrolled wavefront trace where bounce `b` reads a freshly wrapped
    scene: reverse-mode AD then emits one pmean per (leaf, bounce) bucket
    at the point bounce b's backward segment completes, instead of a single
    tree-wide reduction after the full sweep."""
    state = _init_state(origin, direction, max_depth, pixel_ids)
    for bounce in range(max_depth + 1):
        step = _make_bounce_step(_bucket_scene(scene), seed, spp_index,
                                 max_depth, rr_start)
        state, _ = step(bounce, state)
    L, good = state[3], state[4]
    return L, good


def bucketed_train_step(mesh, max_depth: int):
    """The per-bounce-bucketed twin of sharded.sharded_train_step: same
    loss, same gradients (allclose), but the parameter all-reduce is
    issued per bounce inside the backward wavefront."""

    def loss_fn(scene, camera, film, pixel_ids, seed, spp_index, target):
        from craytracer_tpu.camera import generate_rays
        from craytracer_tpu.integrator.wavefront import CAMERA_BOUNCE
        from craytracer_tpu.sampling import uniforms
        from craytracer_tpu.sampling.multijitter import stratified_jitter

        jitter = stratified_jitter(seed, pixel_ids, spp_index)
        lens_u = uniforms(seed, pixel_ids, spp_index, CAMERA_BOUNCE, 2, 2)
        o, d = generate_rays(camera, film, pixel_ids, jitter, lens_u)
        L, _ = trace_paths_bucketed(scene, o, d, seed, pixel_ids, spp_index,
                                    max_depth)
        err = L - target
        return jnp.mean(err * err)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(RAY_AXIS), P(), P(), P(RAY_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _step(scene, camera, film, pixel_ids, seed, spp_index, target):
        loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(
            scene, camera, film, pixel_ids, seed, spp_index, target)
        # loss is still reduced once; parameter grads were bucket-reduced
        # inside the backward sweep by _pmean_grad.
        return jax.lax.pmean(loss, RAY_AXIS), grads

    return jax.jit(_step)
