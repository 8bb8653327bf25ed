"""Geometry sharding over a device-mesh axis — the renderer's SP/CP analog
(SURVEY.md §5.7 "scale scene size by optional geometry sharding with
gathered hit reduction"; §2 parallelism table "TP-like option only if a
scene exceeds HBM").

The reference has no counterpart (its threads share one scene in host
RAM); this is the batched answer to scenes larger than one device's
memory:

* the triangle soup (and its per-shard BVH) is split into contiguous
  blocks along a ``geom`` mesh axis — each device holds 1/G of the
  geometry plus a full copy of the small replicated tables (materials,
  lights, analytic primitives, textures);
* every bounce, each device intersects the full (ray-sharded) batch
  against its block, then the per-shard closest hits are argmin-reduced
  across ``geom`` with one `pmin` (winner rank) + one `psum` (winner's
  filled hit record) — the "gathered hit reduction";
* shadow rays reduce with a single `pmin`;
* shading runs replicated along ``geom`` (identical inputs after the
  reduction, stateless RNG keyed by replicated pixel ids), so no further
  collectives are needed and the radiance output is device-invariant
  along the axis.

Cost model: HBM per device scales 1/G for geometry at the price of
G-way-replicated shading FLOPs and two small collectives per bounce —
the right trade for San-Miguel-class scenes that blow the HBM budget.

Limits: mesh lights are rejected (their CDFs gather global triangle
arrays at shading time); shards are padded to equal triangle counts with
duplicates of their last row (duplicate hits are geometrically identical,
so shading is unaffected; only the global prim id of a pad-row hit is
meaningless, which matters to nothing — triangle prims are never matched
against the light table without mesh lights).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from craytracer_tpu.integrator.wavefront import render_sample
from craytracer_tpu.ops.intersect import Hit
from craytracer_tpu.scene import types as T

RAY_AXIS = "rays"
GEOM_AXIS = "geom"


def reduce_hit(hit: Hit, axis: str, tri_base=None) -> Hit:
    """Argmin-reduce per-shard closest hits across `axis`.

    One `pmin` elects the winning shard per lane (ties break to the lowest
    rank, so all-miss lanes deterministically keep rank 0's miss record);
    one `psum` of the masked record broadcasts the winner's filled hit.
    Gradients flow back through the psum to the winning shard's fill.
    `tri_base` (scalar) rebases shard-local triangle prim ids to global."""
    t_det = jax.lax.stop_gradient(hit.t)
    t_min = jax.lax.pmin(t_det, axis)
    rank = jax.lax.axis_index(axis).astype(jnp.int32)
    cand = jnp.where(t_det <= t_min, rank, jnp.int32(1 << 30))
    win = jax.lax.pmin(cand, axis)
    mine = cand == win

    prim = hit.prim
    if tri_base is not None:
        prim = jnp.where(hit.group == T.GROUP_TRIANGLE,
                         prim + jnp.int32(tri_base), prim)

    def red(x):
        m = mine if x.ndim == 1 else mine[:, None]
        return jax.lax.psum(jnp.where(m, x, jnp.zeros_like(x)), axis)

    return Hit(t=red(hit.t), group=red(hit.group), prim=red(prim),
               point=red(hit.point), normal=red(hit.normal),
               dpdu=red(hit.dpdu), uv=red(hit.uv), mat_id=red(hit.mat_id))


def shard_scene_geometry(scene: T.Scene, n_shards: int, accel: str = "bvh4"):
    """Split `scene`'s triangles into `n_shards` contiguous blocks, build a
    per-shard accel, and stack the shard scenes into one pytree whose
    leaves carry a leading [G] dim (shard with `P(GEOM_AXIS)` on dim 0).

    Returns (stacked_scene, tri_base[G] int32). Non-triangle leaves are
    stacked copies — each device's block is one full replica of the small
    tables, so device memory matches plain replication for them."""
    assert accel in ("bvh", "bvh4"), "geometry sharding supports bvh/bvh4"
    assert scene.mesh_lights.surface_area.shape[0] == 0, (
        "geometry sharding requires scenes without mesh lights: mesh-light "
        "NEE gathers global triangle arrays at shading time")
    n_tris = scene.triangles.mat_id.shape[0]
    assert n_tris >= n_shards, "fewer triangles than geometry shards"

    cols = {f.name: np.asarray(getattr(scene.triangles, f.name))
            for f in dataclasses.fields(T.Triangles)}
    blocks = np.array_split(np.arange(n_tris), n_shards)
    per = max(b.size for b in blocks)

    if accel == "bvh":
        from craytracer_tpu.accel.bvh import build_bvh as _build
    else:
        from craytracer_tpu.accel.bvh4 import build_bvh4 as _build

    shard_scenes, bases, fats = [], [], []
    for b in blocks:
        idx = b if b.size == per else np.concatenate(
            [b, np.full(per - b.size, b[-1], b.dtype)])
        chunk = {k: v[idx] for k, v in cols.items()}
        bvh = _build(chunk["v0"], chunk["v1"], chunk["v2"])
        fats.append(np.asarray(bvh.fat))
        tris = T.Triangles(**{k: jnp.asarray(v) for k, v in chunk.items()})
        shard_scenes.append(scene.replace(triangles=tris, tri_bvh=bvh,
                                          accel=accel))
        bases.append(int(b[0]))

    # equalize node counts so the fat arrays stack: zero rows are
    # unreachable from the root and never traversed
    m_max = max(f.shape[0] for f in fats)
    for i, f in enumerate(fats):
        if f.shape[0] < m_max:
            pad = np.zeros((m_max - f.shape[0], f.shape[1]), f.dtype)
            fats[i] = np.concatenate([f, pad], axis=0)
        shard_scenes[i] = shard_scenes[i].replace(
            tri_bvh=shard_scenes[i].tri_bvh.replace(
                fat=jnp.asarray(fats[i]), n_tris=per))

    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *shard_scenes)
    return stacked, jnp.asarray(bases, jnp.int32)


def make_geom_mesh(n_ray_shards: int, n_geom_shards: int) -> Mesh:
    """2-D mesh: rays × geometry. Lay `geom` innermost so its per-bounce
    pmin/psum ride the fastest links."""
    devs = np.asarray(jax.devices()[: n_ray_shards * n_geom_shards])
    return Mesh(devs.reshape(n_ray_shards, n_geom_shards),
                (RAY_AXIS, GEOM_AXIS))


def _local_scene(scene_stk):
    return jax.tree.map(lambda x: x[0], scene_stk)


def geom_sharded_render_pass(mesh: Mesh, max_depth: int,
                             estimator: str = "reference"):
    """Jitted pass over a (rays, geom) mesh: pixel_ids sharded over rays,
    the stacked scene sharded over geom, radiance replicated over geom."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(GEOM_AXIS), P(GEOM_AXIS), P(), P(), P(RAY_AXIS), P(), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    def _shard(scene_stk, tri_base, camera, film, pixel_ids, seed, spp_index):
        return render_sample(_local_scene(scene_stk), camera, film, pixel_ids,
                             seed, spp_index, max_depth, estimator,
                             geom_axis=GEOM_AXIS, tri_base=tri_base[0])

    return jax.jit(_shard)


def geom_sharded_train_step(mesh: Mesh, max_depth: int):
    """Inverse-rendering step on the 2-D mesh: forward with per-bounce hit
    reduction over `geom`, MSE loss, grads pmean'd over `rays` (each geom
    member computes identical replicated grads for the shared tables; the
    winning shard's geometry grads flow through the hit-record psum)."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(GEOM_AXIS), P(GEOM_AXIS), P(), P(), P(RAY_AXIS), P(), P(),
                  P(RAY_AXIS)),
        out_specs=(P(), P(GEOM_AXIS)),
        check_vma=False,
    )
    def _step(scene_stk, tri_base, camera, film, pixel_ids, seed, spp_index,
              target):
        def loss_fn(scene_stk):
            img = render_sample(_local_scene(scene_stk), camera, film,
                                pixel_ids, seed, spp_index, max_depth,
                                estimator="physical",
                                geom_axis=GEOM_AXIS, tri_base=tri_base[0])
            err = img - target
            return jnp.mean(err * err)

        loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(scene_stk)
        loss = jax.lax.pmean(loss, RAY_AXIS)
        loss = jax.lax.pmean(loss, GEOM_AXIS)

        def reduce(g):
            if g.dtype == jax.dtypes.float0:
                return g
            return jax.lax.pmean(g, RAY_AXIS)

        grads = jax.tree.map(reduce, grads)
        return loss, grads

    return jax.jit(_step)
