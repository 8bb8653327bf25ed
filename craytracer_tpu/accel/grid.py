"""Uniform grid over the triangle soup: host CSR build -> batched 3D-DDA.

Build follows the reference's density-derived resolution
(UniformGrid_create, accelerator/uniformgrid.h:54-134): per-axis cell count
n_i = w_i * (multiplier * num_tris / volume)^(1/3) with multiplier 3
(buildscene.h:705). Cell membership is fully
vectorized (numpy over all (triangle, overlapped-cell) pairs — the round-1
Python triple loop was minutes-to-hours at San-Miguel scale) and culled
with the reference's EXACT triangle-box SAT (testTriangleAABB,
shapes/shapes.cpp:434-567, applied per cell at uniformgrid.h:94-134), so
cells hold only triangles that geometrically intersect them. Cells are CSR arrays in HBM:
(cell_offset[C+1], tri_slot[total]) — the IntVector-per-cell layout
(util/intvector.h) flattened.

Traversal is the Amanatides-Woo 3D-DDA (gridIntersectTest,
intersect.h:61-194) as one `lax.while_loop` over the whole ray batch: each
lane alternates between draining its current cell's triangle list (K at a
time) and stepping the DDA; a lane retires when its best hit lies inside
the current cell (closest-hit) or any occluder is inside the distance bound
(any-hit, gridShadowIntersectTest intersect.h:196-308). Triangle rows are
packed [T, 10] (v0, e1, e2, id) so each probe is ONE gather (see
accel/bvh4.py fat-row note), and per-cell (start, end) offsets are one
two-column gather.
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax
import jax.numpy as jnp
import numpy as np

from craytracer_tpu.constants import K_EPSILON, TMAX
from craytracer_tpu.core import math as vm

TESTS_PER_ITER = 8  # one batched gather per iter: wider is nearly free (latency-bound)


@struct.dataclass
class GridArrays:
    bbox_min: jnp.ndarray  # [3]
    bbox_max: jnp.ndarray  # [3]
    res: jnp.ndarray  # [3] int32 (nx, ny, nz)
    cell_span: jnp.ndarray  # [C, 2] int32 (start, end) into tri_slot
    tri_slot: jnp.ndarray  # [total] int32 triangle ids, cell-grouped
    tri_rows: jnp.ndarray  # [T, 10] packed (v0, e1, e2, id)


def _tri_aabb_sat(tv0, tv1, tv2, cmin, cmax):
    """Vectorized exact triangle-AABB test (testTriangleAABB,
    shapes/shapes.cpp:434-567): box-normal overlap is a precondition here,
    so only the triangle-plane test and the 9 edge cross axes remain."""
    ctr = (cmin + cmax) * 0.5
    h = (cmax - cmin) * 0.5
    a = tv0 - ctr
    b = tv1 - ctr
    c = tv2 - ctr
    e0 = b - a
    e1 = c - b
    e2 = a - c

    ok = np.ones(a.shape[0], bool)
    # 9 cross-product axes L = unit_i x edge_j
    for ax in range(3):
        u = np.zeros(3)
        u[ax] = 1.0
        for e in (e0, e1, e2):
            L = np.cross(u, e)
            r = (np.abs(L) * h).sum(axis=1)
            p0 = (L * a).sum(axis=1)
            p1 = (L * b).sum(axis=1)
            p2 = (L * c).sum(axis=1)
            lo = np.minimum(np.minimum(p0, p1), p2)
            hi = np.maximum(np.maximum(p0, p1), p2)
            ok &= ~((lo > r) | (hi < -r))
    # triangle plane vs box
    n = np.cross(e0, e1)
    r = (np.abs(n) * h).sum(axis=1)
    d = (n * a).sum(axis=1)
    ok &= np.abs(d) <= r
    return ok


def build_grid(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
               multiplier: float = 3.0) -> GridArrays:
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    t = v0.shape[0]
    if t == 0:
        z1 = np.zeros((1, 10), np.float32)
        z1[0, 9] = -1
        return GridArrays(bbox_min=jnp.zeros(3), bbox_max=jnp.ones(3),
                          res=jnp.ones(3, jnp.int32),
                          cell_span=jnp.zeros((1, 2), jnp.int32),
                          tri_slot=jnp.zeros((1,), jnp.int32),
                          tri_rows=jnp.asarray(z1))
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    bmin = tri_min.min(axis=0) - 1e-4
    bmax = tri_max.max(axis=0) + 1e-4
    w = bmax - bmin
    vol = max(float(np.prod(w)), 1e-12)
    s = (multiplier * t / vol) ** (1.0 / 3.0)
    res = np.maximum(1, np.minimum(128, np.round(w * s).astype(np.int64)))
    nx, ny, nz = int(res[0]), int(res[1]), int(res[2])
    cell_w = w / res

    lo = np.clip(((tri_min - bmin) / cell_w).astype(np.int64), 0, res - 1)
    hi = np.clip(((tri_max - bmin) / cell_w).astype(np.int64), 0, res - 1)

    # vectorized (tri, cell) pair expansion
    span = hi - lo + 1  # [T, 3]
    counts = span.prod(axis=1)
    total = int(counts.sum())
    tri_ids = np.repeat(np.arange(t), counts)
    # local index within each tri's cell box, decoded to (ix, iy, iz)
    local = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    sx = span[tri_ids, 0]
    sy = span[tri_ids, 1]
    ix = lo[tri_ids, 0] + local % sx
    iy = lo[tri_ids, 1] + (local // sx) % sy
    iz = lo[tri_ids, 2] + local // (sx * sy)

    # exact SAT cull per pair
    cmin = bmin[None, :] + np.stack([ix, iy, iz], axis=1) * cell_w[None, :]
    keep = _tri_aabb_sat(v0[tri_ids], v1[tri_ids], v2[tri_ids],
                         cmin, cmin + cell_w[None, :])
    tri_ids = tri_ids[keep]
    lin = ((iz[keep] * ny + iy[keep]) * nx + ix[keep]).astype(np.int64)

    order = np.argsort(lin, kind="stable")
    lin = lin[order]
    flat = tri_ids[order]
    n_cells = nx * ny * nz
    counts_per_cell = np.bincount(lin, minlength=n_cells)
    offsets = np.concatenate([[0], np.cumsum(counts_per_cell)])
    cell_span = np.stack([offsets[:-1], offsets[1:]], axis=1)

    tri_rows = np.concatenate([
        v0, v1 - v0, v2 - v0, np.arange(t, dtype=np.float64)[:, None],
    ], axis=1).astype(np.float32)
    return GridArrays(
        bbox_min=jnp.asarray(bmin, np.float32),
        bbox_max=jnp.asarray(bmax, np.float32),
        res=jnp.asarray([nx, ny, nz], jnp.int32),
        cell_span=jnp.asarray(cell_span, jnp.int32),
        tri_slot=jnp.asarray(flat if flat.size else np.zeros(1), jnp.int32),
        tri_rows=jnp.asarray(tri_rows),
    )


def _tri_test_k(grid: GridArrays, o, d, slots, valid, best_t, best_tri,
                any_hit, max_dist):
    """Batched [N, K] cell-triangle test: one gather + dense MT + unrolled
    winner (same one-gather-per-step design as the BVH traversals)."""
    k = slots.shape[1]
    slot_c = jnp.clip(slots, 0, grid.tri_rows.shape[0] - 1)
    row = jnp.take(grid.tri_rows, slot_c, axis=0)  # ONE [N, K, 10] gather
    # Unrolled to pure [N] vectors (see bvh4._traverse4).
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    for j in range(k):
        v0x, v0y, v0z = row[:, j, 0], row[:, j, 1], row[:, j, 2]
        e1x, e1y, e1z = row[:, j, 3], row[:, j, 4], row[:, j, 5]
        e2x, e2y, e2z = row[:, j, 6], row[:, j, 7], row[:, j, 8]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = 1.0 / vm._safe(det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        beta = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        gamma = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (valid[:, j] & (beta >= 0.0) & (gamma >= 0.0)
              & (beta + gamma <= 1.0) & (tt > K_EPSILON) & (tt < best_t))
        if any_hit:
            ok = ok & (tt < max_dist)
        best_tri = jnp.where(ok, slot_c[:, j], best_tri)
        best_t = jnp.where(ok, tt, best_t)
    return best_t, best_tri


def _tri_test(grid: GridArrays, o, d, slot, valid, best_t, best_tri, any_hit,
              max_dist):
    slot_c = jnp.clip(slot, 0, grid.tri_rows.shape[0] - 1)
    row = jnp.take(grid.tri_rows, slot_c, axis=0)  # ONE gather
    tv0 = row[:, 0:3]
    te1 = row[:, 3:6]
    te2 = row[:, 6:9]
    pvec = vm.cross(d, te2)
    det = vm.dot(te1, pvec)
    inv_det = 1.0 / vm._safe(det)
    tvec = o - tv0
    beta = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, te1)
    gamma = vm.dot(d, qvec) * inv_det
    tt = vm.dot(te2, qvec) * inv_det
    ok = (valid & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
          & (tt > K_EPSILON) & (tt < best_t))
    if any_hit:
        ok = ok & (tt < max_dist)
    best_tri = jnp.where(ok, slot_c, best_tri)
    best_t = jnp.where(ok, tt, best_t)
    return best_t, best_tri


def _traverse(grid: GridArrays, o, d, any_hit: bool, max_dist=None):
    n = o.shape[0]
    if max_dist is None:
        max_dist = jnp.full((n,), TMAX)
    inv_d = 1.0 / vm._safe(d)
    res = grid.res
    resf = res.astype(o.dtype)
    cell_w = (grid.bbox_max - grid.bbox_min) / resf

    # Ray-box entry (intersect.h:75-104): rays starting inside use t=0.
    t0 = (grid.bbox_min - o) * inv_d
    t1 = (grid.bbox_max - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    t_enter = jnp.maximum(tn, 0.0)
    inside = (tn <= tf) & (tf > 0.0)

    p_enter = o + (t_enter + 1e-5)[:, None] * d
    cell = jnp.clip(
        ((p_enter - grid.bbox_min) / cell_w).astype(jnp.int32), 0, res - 1
    )
    step = jnp.where(d > 0.0, 1, -1).astype(jnp.int32)
    next_boundary = grid.bbox_min + (cell + jnp.where(d > 0.0, 1, 0)) * cell_w
    t_max = jnp.where(
        jnp.abs(d) > 1e-12, (next_boundary - o) * inv_d, TMAX
    )
    t_delta = jnp.abs(cell_w * inv_d)

    def cell_range(cell):
        lin = (cell[:, 2] * res[1] + cell[:, 1]) * res[0] + cell[:, 0]
        lin = jnp.clip(lin, 0, grid.cell_span.shape[0] - 1)
        span = jnp.take(grid.cell_span, lin, axis=0)  # one 2-col gather
        return span[:, 0], span[:, 1]

    cur, end = cell_range(cell)

    best_t = jnp.full((n,), TMAX)
    best_tri = jnp.full((n,), -1, jnp.int32)
    alive = inside

    state = (alive, cell, t_max, cur, end, best_t, best_tri)

    def cond(state):
        alive, *_ = state
        return jnp.any(alive)

    def body(state):
        alive, cell, t_max, cur, end, best_t, best_tri = state
        drain = alive & (cur < end)

        # Test up to K triangles from the current cell in ONE batched
        # gather ([N, K] slot matrix) instead of K separate takes.
        idx = cur[:, None] + jnp.arange(TESTS_PER_ITER, dtype=jnp.int32)[None, :]
        valid = drain[:, None] & (idx < end[:, None])  # [N, K]
        slots = jnp.take(grid.tri_slot,
                         jnp.clip(idx, 0, grid.tri_slot.shape[0] - 1))
        best_t, best_tri = _tri_test_k(grid, o, d, slots, valid, best_t,
                                       best_tri, any_hit, max_dist)
        cur = jnp.where(drain, jnp.minimum(cur + TESTS_PER_ITER, end), cur)

        # Advance the DDA for lanes whose cell is drained.
        advance = alive & (cur >= end)
        t_exit = jnp.min(t_max, axis=-1)
        # hit inside the current cell -> done (intersect.h:151-166)
        done_hit = advance & (best_t <= t_exit + 1e-5)
        if any_hit:
            done_hit = done_hit | (alive & (best_t < max_dist))
        ax = jnp.argmin(t_max, axis=-1)
        onehot = jax.nn.one_hot(ax, 3, dtype=jnp.int32)
        new_cell = cell + onehot * step
        oob = jnp.any((new_cell < 0) | (new_cell >= res), axis=-1)
        new_t_max = t_max + onehot.astype(t_max.dtype) * t_delta
        stepping = advance & ~done_hit & ~oob
        cell = jnp.where(stepping[:, None], new_cell, cell)
        t_max = jnp.where(stepping[:, None], new_t_max, t_max)
        new_cur, new_end = cell_range(cell)
        cur = jnp.where(stepping, new_cur, cur)
        end = jnp.where(stepping, new_end, end)
        alive = alive & ~(advance & (done_hit | oob))
        return alive, cell, t_max, cur, end, best_t, best_tri

    state = jax.lax.while_loop(cond, body, state)
    *_, best_t, best_tri = state
    # slots are original triangle ids (no reordering in the grid layout)
    return best_t, best_tri


def grid_closest_hit(grid: GridArrays, o, d):
    return _traverse(grid, o, d, any_hit=False)


def grid_any_hit(grid: GridArrays, o, d, max_dist):
    t, _ = _traverse(grid, o, d, any_hit=True, max_dist=max_dist)
    return t
