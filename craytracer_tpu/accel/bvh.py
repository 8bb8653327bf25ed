"""BVH over the triangle soup: host build -> flat SoA arrays -> batched
stack traversal.

Build mirrors the reference's median-split strategy (BVH_build,
accelerator/bvh.h:117-154: split the largest-extent axis at the centroid
median) but with <=4-triangle leaves like the QBVH (accelerator/
bvh4.h:258-296) so the leaf test vectorizes — the SSE 1-ray-4-triangle
kernel (shapes/triangle.cpp:81-151) becomes a masked 4-wide batched test.

Traversal replaces the reference's recursion (intersect.h:310-342) with an
iterative near-child-first ordered stack walk (the QBVH's sign-ordered
descent, accelerator/bvh4.h:306-352), vectorized across the whole ray batch
inside one `lax.while_loop`: every live lane processes one node per
iteration; t-bound culling prunes as best hits tighten. Any-hit
(shadow) terminates a lane as soon as any occluder closer than its bound is
found (intersect.h:443-545 semantics).

Node layout (depth-first): internal nodes store the right-child index and
split axis (left child is node+1); leaves store (first_tri, count) into a
leaf-reordered triangle index array.

FAT node rows (same rationale as accel/bvh4.py): one gather per
traversal step costs less than many narrow ones, so each node row
inlines its box, right/axis, and the leaf's <=LEAF_SIZE triangles
(v0/e1/e2/orig-id) — ONE gather per traversal step instead of 22.
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax
import jax.numpy as jnp
import numpy as np

from craytracer_tpu.constants import K_EPSILON, TMAX
from craytracer_tpu.core import math as vm

LEAF_SIZE = 4
# Upper cap on the per-tree static stack bound. Stacks are stored
# TRANSPOSED as [S, N] (major-dim stack index) so pop/push traffic is the
# true S*N — an [N, S] layout would lane-pad S to 128 and cost the same
# for any S. S itself comes from the tree depth at build time
# (BVHArrays.stack_size / BVH4Arrays.stack_size); 128 rigorously covers
# SAH trees (depth-capped at 32 SAH levels + log-median remainder,
# native/craynative.cpp::sah_split).
MAX_STACK = 128


# Fat-row layout: [0:3) min, [3:6) max, [6] right child (-1 = leaf),
# [7] split axis, [8:8+LEAF_SIZE*10) leaf tris (v0[3], e1[3], e2[3], id).
_TRI_COLS = 10
_BIN_TRI0 = 8
BIN_FAT_WIDTH = _BIN_TRI0 + LEAF_SIZE * _TRI_COLS


@struct.dataclass
class BVHArrays:
    fat: jnp.ndarray  # [M, BIN_FAT_WIDTH]
    n_tris: int = struct.field(pytree_node=False, default=0)
    # Static per-tree stack bound (depth+4, computed at build). The stack
    # is stored [stack_size, N] — major-dim stack index — so pop/push
    # traffic is stack_size*N exactly instead of the minor-dim 128-lane
    # padding of an [N, S] layout (see bvh4.BVH4Arrays.stack_size).
    stack_size: int = struct.field(pytree_node=False, default=MAX_STACK)


def _stack_bound_bin(fat_np) -> int:
    """Host BFS depth of the binary tree -> static stack bound. Each step
    pops one node and pushes at most 2 (net +1), so sp <= depth + 1."""
    right = np.asarray(fat_np[:, 6], np.int64)
    frontier = np.array([0], np.int64)
    depth = 0
    while frontier.size and depth < 200:
        depth += 1
        r = right[frontier]
        internal = frontier[r >= 0]
        frontier = np.concatenate([internal + 1, right[internal]])
    bound = depth + 4
    return int(min(MAX_STACK, max(16, ((bound + 7) // 8) * 8)))


def _build_arrays(v0, v1, v2, leaf_size=LEAF_SIZE):
    t = v0.shape[0]
    # f32 throughout: the native builder (craynative.cpp) computes bounds
    # and centroids in f32, and split decisions must agree bit-for-bit —
    # an f64 centroid can order differently within 1 ulp of a tie.
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * np.float32(0.5)

    nodes = []  # dicts
    order: list[int] = []

    import sys

    def build(ids):
        idx = len(nodes)
        nodes.append({})
        n = nodes[idx]
        n["min"] = tri_min[ids].min(axis=0)
        n["max"] = tri_max[ids].max(axis=0)
        if len(ids) <= leaf_size:
            n["first"] = len(order)
            n["count"] = len(ids)
            n["right"] = -1
            n["axis"] = 0
            order.extend(ids.tolist())
            return idx
        ext = centroid[ids].max(axis=0) - centroid[ids].min(axis=0)
        ax = int(np.argmax(ext))
        # Strict (centroid, id) key — a total order, so the split is
        # independent of the parent's ordering; matches the native
        # presorted-partition builder bit-for-bit (native/craynative.cpp).
        med = np.lexsort((ids, centroid[ids, ax]))
        half = len(ids) // 2
        n["first"] = -1
        n["count"] = 0
        n["axis"] = ax
        build(ids[med[:half]])
        n["right"] = build(ids[med[half:]])
        return idx

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * int(np.ceil(np.log2(max(t, 2)))) * 64))
    try:
        build(np.arange(t))
    finally:
        sys.setrecursionlimit(old_limit)
    return nodes, order


def build_bvh_arrays(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     leaf_size: int = LEAF_SIZE) -> BVHArrays:
    """Host-side build -> fat-row BVHArrays (device)."""
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    t = v0.shape[0]
    if t == 0:
        fat = np.zeros((1, BIN_FAT_WIDTH), np.float32)
        fat[:, 6] = -1.0
        fat[:, _BIN_TRI0 + _TRI_COLS - 1::_TRI_COLS] = -1.0
        return BVHArrays(fat=jnp.asarray(fat), n_tris=0, stack_size=16)
    if t >= (1 << 24):
        raise ValueError("fat-row BVH inlines f32 triangle ids; "
                         "triangle count must stay below 2^24")
    from craytracer_tpu.native import build_bvh_fat_native, build_bvh_native

    # Full C++ path: build + fat assembly in one native call (the numpy
    # assembly below runs at MB/s on the target host — San-Miguel-scale
    # meshes need this; bit-identical output).
    fat_nat = build_bvh_fat_native(v0, v1, v2, leaf_size)
    if fat_nat is not None:
        return BVHArrays(fat=jnp.asarray(fat_nat), n_tris=t,
                         stack_size=_stack_bound_bin(fat_nat))

    nat = build_bvh_native(v0, v1, v2, leaf_size)
    if nat is not None:
        node_min, node_max, right, axis, first, count, order_np = nat
    else:
        nodes, order = _build_arrays(v0, v1, v2, leaf_size)
        node_min = np.stack([n["min"] for n in nodes]).astype(np.float32)
        node_max = np.stack([n["max"] for n in nodes]).astype(np.float32)
        right = np.asarray([n["right"] for n in nodes], np.int32)
        axis = np.asarray([n["axis"] for n in nodes], np.int32)
        first = np.asarray([n["first"] for n in nodes], np.int32)
        count = np.asarray([n["count"] for n in nodes], np.int32)
        order_np = np.asarray(order, np.int32)

    order64 = order_np.astype(np.int64)
    pv0 = v0[order64].astype(np.float32)
    pe1 = (v1[order64] - v0[order64]).astype(np.float32)
    pe2 = (v2[order64] - v0[order64]).astype(np.float32)
    tri_rows = np.concatenate(
        [pv0, pe1, pe2, order_np.astype(np.float32)[:, None]], axis=1)

    m = node_min.shape[0]
    first64 = first.astype(np.int64)
    slots = first64[:, None] + np.arange(LEAF_SIZE)[None, :]  # [M, L]
    valid = (first64[:, None] >= 0) & (np.arange(LEAF_SIZE)[None, :]
                                       < count.astype(np.int64)[:, None])
    pad = np.zeros(_TRI_COLS, np.float32)
    pad[-1] = -1.0
    blocks = np.where(valid[..., None], tri_rows[np.clip(slots, 0, t - 1)], pad)
    fat = np.concatenate([
        node_min.astype(np.float32), node_max.astype(np.float32),
        right.astype(np.float32)[:, None], axis.astype(np.float32)[:, None],
        blocks.reshape(m, LEAF_SIZE * _TRI_COLS),
    ], axis=1).astype(np.float32)
    return BVHArrays(fat=jnp.asarray(fat), n_tris=t,
                     stack_size=_stack_bound_bin(fat))


# keep the public name pointing at the working implementation
build_bvh = build_bvh_arrays


def _traverse(bvh: BVHArrays, o, d, any_hit: bool, max_dist=None):
    """Fat-row stack traversal: one gather per step (module docstring)."""
    n = o.shape[0]
    inv_d = 1.0 / vm._safe(d)
    neg_dir = d < 0.0  # [N, 3]
    if max_dist is None:
        max_dist = jnp.full((n,), TMAX)

    # [S, n] stack, S a per-tree static bound (see BVHArrays.stack_size).
    S = int(getattr(bvh, "stack_size", MAX_STACK))
    stack = jnp.zeros((S, n), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root pushed
    best_t = jnp.full((n,), TMAX)
    best_tri = jnp.full((n,), -1, jnp.int32)
    n_nodes = bvh.fat.shape[0]

    def cond(state):
        sp, *_ = state
        return jnp.any(sp > 0)

    iota_s = jnp.arange(S, dtype=jnp.int32)[:, None]

    def body(state):
        sp, stack, best_t, best_tri = state
        active = sp > 0
        # dense pop (see bvh4._traverse4: one gather per step)
        top = sp - 1
        node = jnp.sum(jnp.where(iota_s == top[None, :], stack, 0), axis=0)
        sp = jnp.where(active, top, sp)
        node_c = jnp.where(active, jnp.clip(node, 0, n_nodes - 1), 0)

        row = jnp.take(bvh.fat, node_c, axis=0)  # THE gather

        # Unrolled to pure [N] vectors (see bvh4._traverse4).
        col = lambda j: row[:, j]  # noqa: E731
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        ivx, ivy, ivz = inv_d[:, 0], inv_d[:, 1], inv_d[:, 2]
        right = col(6).astype(jnp.int32)
        axis = col(7).astype(jnp.int32)

        t0x = (col(0) - ox) * ivx
        t1x = (col(3) - ox) * ivx
        t0y = (col(1) - oy) * ivy
        t1y = (col(4) - oy) * ivy
        t0z = (col(2) - oz) * ivz
        t1z = (col(5) - oz) * ivz
        tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                     jnp.minimum(t0y, t1y)),
                         jnp.minimum(t0z, t1z))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                     jnp.maximum(t0y, t1y)),
                         jnp.maximum(t0z, t1z))
        tlimit = jnp.minimum(best_t, max_dist)
        box_hit = active & (tn <= tf) & (tf > 0.0) & (tn < tlimit)

        # Leaf triangles, tested unconditionally (pads/misses cannot win).
        for k in range(LEAF_SIZE):
            b = _BIN_TRI0 + k * _TRI_COLS
            v0x, v0y, v0z = col(b + 0), col(b + 1), col(b + 2)
            e1x, e1y, e1z = col(b + 3), col(b + 4), col(b + 5)
            e2x, e2y, e2z = col(b + 6), col(b + 7), col(b + 8)
            tid = col(b + 9).astype(jnp.int32)
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
            ok = (active & (tid >= 0) & (beta >= 0.0) & (gamma >= 0.0)
                  & (beta + gamma <= 1.0) & (tt > K_EPSILON) & (tt < best_t))
            if any_hit:
                ok = ok & (tt < max_dist)
            best_tri = jnp.where(ok, tid, best_tri)
            best_t = jnp.where(ok, tt, best_t)

        # Internal: push far then near (near popped first), ordered by ray
        # sign along the split axis (accelerator/bvh4.h:306-352).
        do_push = box_hit & (right >= 0)
        left = node + 1
        # dense axis select (axis in {0,1,2}) instead of take_along_axis
        neg_ax = jnp.where(axis == 0, neg_dir[:, 0],
                           jnp.where(axis == 1, neg_dir[:, 1], neg_dir[:, 2]))
        go_left_first = ~neg_ax
        near = jnp.where(go_left_first, left, right)
        far = jnp.where(go_left_first, right, left)
        sp_ok = sp <= S - 2
        do_push = do_push & sp_ok
        # one combined write for both pushes
        rel = iota_s - sp[None, :]
        pick = jnp.where(rel >= 1, near[None, :], far[None, :])
        stack = jnp.where(do_push[None, :] & (rel >= 0) & (rel < 2), pick,
                          stack)
        sp = jnp.where(do_push, sp + 2, sp)

        # Any-hit early out: a sufficient occluder ends the lane.
        if any_hit:
            sp = jnp.where(best_t < max_dist, 0, sp)
        return sp, stack, best_t, best_tri

    sp, stack, best_t, best_tri = jax.lax.while_loop(
        cond, body, (sp, stack, best_t, best_tri)
    )
    return best_t, best_tri


def bvh_closest_hit(bvh: BVHArrays, o, d):
    """Returns (t[N], tri_id[N]) with t=TMAX / tri=-1 on miss."""
    return _traverse(bvh, o, d, any_hit=False)


def bvh_any_hit(bvh: BVHArrays, o, d, max_dist):
    """Returns t[N] of some occluder with t < max_dist, else TMAX."""
    t, _ = _traverse(bvh, o, d, any_hit=True, max_dist=max_dist)
    return t
