"""4-wide (QBVH) traversal: the reference's shallow-BVH design
(accelerator/bvh4.h, after Dammertz/Hanika/Keller) in batched form.

Built by collapsing the binary BVH one level (each node adopts its
grandchildren), so the tree is half as deep — and since the batched
traversal's wall time is dominated by the `lax.while_loop` trip count (the
max node-visit chain over all lanes), the 4-box-per-iteration test roughly
halves the serial depth at the cost of wider (but dense) per-step
work — exactly the trade the reference's SSE 4-box slab test makes
(rayIntersectAABB4, accelerator/bvh4.h:23-97).

Node layout (SoA, the batched analog of BVHNode4's float[24] box block):
  child_min/child_max: [M, 4, 3] — 4 child boxes per node
  child:               [M, 4]    — child node index, or -1 empty
  leaf_first/leaf_count:[M, 4]   — per-child leaf triangle range (count 0 =
                                   internal child)
Children are tested simultaneously; hits are pushed far-to-near (insertion
sort over 4 via masked swaps) so the nearest pops first.

The FAT-ROW traversal: instead of ~69 gathers per while-loop step (5
node fields + 4 child slots x LEAF_SIZE tris x 3 vertex arrays), this
build packs EVERYTHING a traversal step needs into one fat row — 4 child
boxes, child ids, leaf counts, and all 4 leaf children's triangles
(v0/e1/e2/orig-id, padded to LEAF_SIZE) — so each step is ONE gather plus
dense elementwise math.
Triangles of missed child boxes are tested anyway (correctness-neutral:
a triangle inside a missed or too-far box can never beat best_t; padded
slots carry degenerate data that never hits) — masking would cost more
than the 16 extra Moller-Trumbore lanes.
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax
import jax.numpy as jnp
import numpy as np

from craytracer_tpu.constants import K_EPSILON, TMAX
from craytracer_tpu.core import math as vm
from craytracer_tpu.accel.bvh import LEAF_SIZE, MAX_STACK, _build_arrays

WIDTH = 4


# Fat-row layout (see module docstring): per-node f32 columns
#   [0:12)   4 child mins, [12:24) 4 child maxs, [24:28) child node ids
#   [28:28+16*10) 4 children x LEAF_SIZE tris x (v0[3], e1[3], e2[3], id)
_TRI_COLS = 10
_FAT_TRI0 = 28
FAT_WIDTH = _FAT_TRI0 + WIDTH * LEAF_SIZE * _TRI_COLS


@struct.dataclass
class BVH4Arrays:
    fat: jnp.ndarray  # [M, >=fat_width(leaf_size)] fat node rows
    n_tris: int = struct.field(pytree_node=False, default=0)
    # Static so jit specializes the row slicing. leaf_size=2 keeps the
    # row at 108 cols (one 128-column row), trading ~1 extra tree level
    # for a narrower per-step gather (a choice made for the previous
    # accelerator, not yet re-measured on the GPU: ROADMAP.md 1f).
    leaf_size: int = struct.field(pytree_node=False, default=LEAF_SIZE)
    # Static per-tree stack bound (3*depth + margin, computed at build):
    # the traversal stack is [stack_size, N] — stack index in the MAJOR
    # dim, so pop/push traffic is stack_size*N exactly instead of the
    # minor-dim padding a [N, S] layout can pay. Class-attr default
    # keeps pickles from before this field loading (dataclass defaults
    # resolve via the class).
    stack_size: int = struct.field(pytree_node=False, default=MAX_STACK)


def fat_width(leaf_size: int) -> int:
    return _FAT_TRI0 + WIDTH * leaf_size * _TRI_COLS


def _stack_bound(fat_np) -> int:
    """Host-side BFS depth of the 4-wide tree -> static stack bound.

    Each while-loop step pops one node and pushes at most WIDTH children
    (net +3), so sp never exceeds 3*depth + 1; a +4 margin and multiple-
    of-8 rounding keep the bound conservative and layout-friendly."""
    return stack_bound_children(np.asarray(fat_np[:, 24:28], np.int64))


def stack_bound_children(child) -> int:
    """BFS depth bound from a [M, W] child-index array (-1 = none)."""
    child = np.asarray(child, np.int64)
    frontier = np.array([0], np.int64)
    depth = 0
    while frontier.size and depth < 200:
        depth += 1
        nxt = child[frontier].reshape(-1)
        frontier = nxt[nxt >= 0]
    bound = 3 * depth + 4
    return int(min(MAX_STACK, max(16, ((bound + 7) // 8) * 8)))


def _pad128(fat: np.ndarray) -> np.ndarray:
    """Pad rows below 128 cols up to 128 (aligned gathers measure faster:
    1x128 0.74ms vs 1x108 1.08ms at 262k lanes)."""
    w = fat.shape[1]
    if w < 128:
        fat = np.pad(fat, ((0, 0), (0, 128 - w)))
    return fat


def collapse4(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              leaf_size: int = LEAF_SIZE):
    """Host-side binary-BVH build + one-level collapse into 4-wide nodes.

    Returns numpy (mins[M,4,3], maxs[M,4,3], child[M,4], lf[M,4], lc[M,4],
    order[T], pv0/pe1/pe2[T,3]) — shared by the fat-row builder here and the
    quantized builder in bvh4q.py."""
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    t = v0.shape[0]

    from craytracer_tpu.native import build_bvh_native

    nat = build_bvh_native(v0, v1, v2, leaf_size)
    if nat is not None:
        node_min, node_max, right, axis, first, count, order = nat
    else:
        nodes, order_l = _build_arrays(v0, v1, v2, leaf_size)
        node_min = np.stack([n["min"] for n in nodes]).astype(np.float32)
        node_max = np.stack([n["max"] for n in nodes]).astype(np.float32)
        right = np.asarray([n["right"] for n in nodes], np.int32)
        first = np.asarray([n["first"] for n in nodes], np.int32)
        count = np.asarray([n["count"] for n in nodes], np.int32)
        order = np.asarray(order_l, np.int32)

    node_min = np.asarray(node_min, np.float64)
    node_max = np.asarray(node_max, np.float64)
    right = np.asarray(right, np.int64)
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    is_leaf_arr = count > 0

    if is_leaf_arr[0]:
        # single-leaf tree: one q node whose first slot is the leaf
        mins = np.ones((1, WIDTH, 3), np.float32)
        maxs = -np.ones((1, WIDTH, 3), np.float32)
        child = np.full((1, WIDTH), -1, np.int64)
        lf = np.full((1, WIDTH), -1, np.int64)
        lc = np.zeros((1, WIDTH), np.int64)
        mins[0, 0] = node_min[0]
        maxs[0, 0] = node_max[0]
        lf[0, 0] = first[0]
        lc[0, 0] = count[0]
    else:
        # Vectorized level-order collapse (the recursive per-node emit was
        # the build bottleneck at millions of triangles): each BFS wave of
        # binary internal nodes becomes a wave of 4-wide nodes; a node's 4
        # slots are its grandchildren where its children are internal, the
        # children themselves where they are leaves (-1 = empty slot).
        waves = []  # (slots[F,4] binary ids or -1)
        frontier = np.array([0], np.int64)
        total = 0
        starts = []
        while frontier.size:
            starts.append(total)
            total += frontier.size
            l = frontier + 1
            r = right[frontier]
            leaf_l = is_leaf_arr[l]
            leaf_r = is_leaf_arr[r]
            s0 = np.where(leaf_l, l, l + 1)
            s1 = np.where(leaf_l, -1, right[l])
            s2 = np.where(leaf_r, r, r + 1)
            s3 = np.where(leaf_r, -1, right[r])
            slots = np.stack([s0, s1, s2, s3], axis=1)  # [F, 4]
            waves.append(slots)
            flat = slots.reshape(-1)
            internal = flat[(flat >= 0) & ~is_leaf_arr[np.maximum(flat, 0)]]
            frontier = internal

        slots = np.concatenate(waves, axis=0)  # [M, 4] binary ids or -1
        m = slots.shape[0]
        # q-node id per binary internal node: BFS visit order
        q_of_binary = np.full(node_min.shape[0], -1, np.int64)
        visit = np.concatenate(
            [w.reshape(-1) for w in waves])  # appearance order of slots
        # ids are assigned wave by wave in row-major slot order:
        flat_internal = visit[(visit >= 0) & ~is_leaf_arr[np.maximum(visit, 0)]]
        q_of_binary[0] = 0
        q_of_binary[flat_internal] = np.arange(1, 1 + flat_internal.size)

        valid = slots >= 0
        sc = np.maximum(slots, 0)
        slot_leaf = valid & is_leaf_arr[sc]
        slot_int = valid & ~is_leaf_arr[sc]
        mins = np.where(valid[..., None], node_min[sc], 1.0).astype(np.float32)
        maxs = np.where(valid[..., None], node_max[sc], -1.0).astype(np.float32)
        child = np.where(slot_int, q_of_binary[sc], -1)
        lf = np.where(slot_leaf, first[sc], -1)
        lc = np.where(slot_leaf, count[sc], 0)

    order64 = order.astype(np.int64)
    pv0 = v0[order64].astype(np.float32)
    pe1 = (v1[order64] - v0[order64]).astype(np.float32)
    pe2 = (v2[order64] - v0[order64]).astype(np.float32)
    return (mins.reshape(-1, WIDTH, 3), maxs.reshape(-1, WIDTH, 3), child,
            lf, lc, order, pv0, pe1, pe2)


def build_bvh4(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
               leaf_size: int = LEAF_SIZE,
               split: str = "median") -> BVH4Arrays:
    """4-wide BVH with fat node rows (see module docstring)."""
    t = np.asarray(v0).shape[0]
    if t == 0:
        fat = np.zeros((1, fat_width(leaf_size)), np.float32)
        fat[:, 24:28] = -1.0  # no children
        fat[:, _FAT_TRI0 + _TRI_COLS - 1::_TRI_COLS] = -1.0  # no tris
        return BVH4Arrays(fat=jnp.asarray(_pad128(fat)), n_tris=0,
                          leaf_size=leaf_size, stack_size=16)
    if t >= (1 << 24):
        raise ValueError("fat-row BVH4 inlines f32 triangle ids; "
                         "triangle count must stay below 2^24")
    from craytracer_tpu.native import build_bvh4_fat_native

    # Full C++ path: binary build + BFS collapse + fat assembly in one
    # native call (the numpy assembly below runs at MB/s on the target
    # host — San-Miguel-scale meshes need this; bit-identical output).
    fat_nat = build_bvh4_fat_native(v0, v1, v2, leaf_size, split)
    if fat_nat is not None:
        return BVH4Arrays(fat=jnp.asarray(_pad128(fat_nat)), n_tris=t,
                          leaf_size=leaf_size,
                          stack_size=_stack_bound(fat_nat))

    if split != "median":
        import warnings

        warnings.warn("SAH split needs the native builder; falling back "
                      "to median (numpy path)")
    mins, maxs, child, lf, lc, order, pv0, pe1, pe2 = collapse4(
        v0, v1, v2, leaf_size)
    m = mins.shape[0]
    child = child.astype(np.float32)

    # vectorized fat-row assembly
    tri_rows = np.concatenate(
        [pv0, pe1, pe2, order.astype(np.float32)[:, None]], axis=1)  # [T,10]
    slots = lf[:, :, None] + np.arange(leaf_size)[None, None, :]  # [M,4,L]
    valid = (lf[:, :, None] >= 0) & (np.arange(leaf_size)[None, None, :] < lc[:, :, None])
    pad = np.zeros(_TRI_COLS, np.float32)
    pad[-1] = -1.0  # degenerate tri: zero edges never hit, id -1 guards
    blocks = np.where(valid[..., None],
                      tri_rows[np.clip(slots, 0, t - 1)], pad)  # [M,4,L,10]
    fat = np.concatenate([
        mins.reshape(m, 12), maxs.reshape(m, 12), child,
        blocks.reshape(m, WIDTH * leaf_size * _TRI_COLS),
    ], axis=1).astype(np.float32)
    return BVH4Arrays(fat=jnp.asarray(_pad128(fat)), n_tris=t,
                      leaf_size=leaf_size, stack_size=_stack_bound(fat))


def _traverse4(bvh: BVH4Arrays, o, d, any_hit: bool, max_dist=None,
               with_stats: bool = False):
    """Fat-row stack traversal: ONE [N] gather per step (module docstring).

    The loop body keeps exactly one gather (the fat row) and expresses
    everything else as dense masked ops: the stack pop is a masked
    reduction over [N, S], the four child pushes collapse into one
    relative-offset select, and the 16-slot leaf winner is an unrolled
    compare chain instead of argmin + take_along. Each while-loop trip
    costs the longest lane's chain (ROADMAP.md 1c)."""
    n = o.shape[0]
    inv_d = 1.0 / vm._safe(d)
    if max_dist is None:
        max_dist = jnp.full((n,), TMAX)

    # Stack layout [S, n]: stack index in the MAJOR dim, so every pop
    # (masked reduce) and push (masked select) moves S*n words with S a
    # per-tree static bound (3*depth+4, typically 48-64).
    S = int(bvh.stack_size)
    stack = jnp.zeros((S, n), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root node 0 pushed
    best_t = jnp.full((n,), TMAX)
    best_tri = jnp.full((n,), -1, jnp.int32)
    n_nodes = bvh.fat.shape[0]
    k_slots = WIDTH * bvh.leaf_size
    iota_s = jnp.arange(S, dtype=jnp.int32)[:, None]

    pops = jnp.zeros((n,), jnp.int32)  # per-lane node visits (with_stats)

    def cond(state):
        sp, *_ = state
        return jnp.any(sp > 0)

    def body(state):
        sp, stack, best_t, best_tri, pops = state
        active = sp > 0
        if with_stats:
            pops = pops + active.astype(jnp.int32)
        # dense pop: masked reduction instead of take_along_axis (gather)
        top = sp - 1
        node = jnp.sum(jnp.where(iota_s == top[None, :], stack, 0), axis=0)
        sp = jnp.where(active, top, sp)
        node_c = jnp.where(active, jnp.clip(node, 0, n_nodes - 1), 0)

        row = jnp.take(bvh.fat, node_c, axis=0)  # [N, FAT_WIDTH] — THE gather

        # Everything below is unrolled to pure [N] vectors: no small
        # minor dimension ([N,4,3], [N,K,10]) is materialized.
        col = lambda j: row[:, j]  # noqa: E731
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        ivx, ivy, ivz = inv_d[:, 0], inv_d[:, 1], inv_d[:, 2]

        # 4-box slab test (rayIntersectAABB4, accelerator/bvh4.h:23-97)
        tlimit = jnp.minimum(best_t, max_dist)
        tn_c, box_hit_c, child_c = [], [], []
        for c in range(WIDTH):
            t0x = (col(c * 3 + 0) - ox) * ivx
            t1x = (col(12 + c * 3 + 0) - ox) * ivx
            t0y = (col(c * 3 + 1) - oy) * ivy
            t1y = (col(12 + c * 3 + 1) - oy) * ivy
            t0z = (col(c * 3 + 2) - oz) * ivz
            t1z = (col(12 + c * 3 + 2) - oz) * ivz
            tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                         jnp.minimum(t0y, t1y)),
                             jnp.minimum(t0z, t1z))
            tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                         jnp.maximum(t0y, t1y)),
                             jnp.maximum(t0z, t1z))
            tn_c.append(tn)
            box_hit_c.append(active & (tn <= tf) & (tf > 0.0) & (tn < tlimit))
            child_c.append(col(24 + c).astype(jnp.int32))

        # All inlined leaf triangles, tested unconditionally (misses/pads
        # cannot produce a valid closer t), winner folded per slot.
        for k in range(k_slots):
            b = _FAT_TRI0 + k * _TRI_COLS
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

        # push internal children ordered far-to-near by tn (nearest on top):
        # insertion sort of 4 (tn, child) pairs via masked compare-swaps
        is_int_child = [(child_c[c] >= 0) & box_hit_c[c] for c in range(WIDTH)]
        key = [jnp.where(is_int_child[c], tn_c[c], -jnp.inf)
               for c in range(WIDTH)]  # far = larger key first

        def swap(kc, i, j):
            # ensure key[i] >= key[j] (descending); invalid (-inf) sink last
            key, cval = kc
            do = key[i] < key[j]
            ki = jnp.where(do, key[j], key[i])
            kj = jnp.where(do, key[i], key[j])
            vi = jnp.where(do, cval[j], cval[i])
            vj = jnp.where(do, cval[i], cval[j])
            key = [ki if s == i else kj if s == j else key[s] for s in range(WIDTH)]
            cval = [vi if s == i else vj if s == j else cval[s] for s in range(WIDTH)]
            return key, cval

        kc = (key,
              [jnp.where(is_int_child[s], child_c[s], -1) for s in range(WIDTH)])
        for ij in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
            kc = swap(kc, *ij)
        cval = kc[1]  # descending by tn; valid children first
        npush = sum((c >= 0).astype(jnp.int32) for c in cval)
        npush = jnp.minimum(npush, S - sp)
        # one combined write: slot sp+r takes the r-th sorted child
        rel = iota_s - sp[None, :]  # [S, N]
        pick = cval[0][None, :]
        for r in range(1, WIDTH):
            pick = jnp.where(rel >= r, cval[r][None, :], pick)
        stack = jnp.where((rel >= 0) & (rel < npush[None, :]), pick, stack)
        sp = sp + npush

        if any_hit:
            sp = jnp.where(best_t < max_dist, 0, sp)
        return sp, stack, best_t, best_tri, pops

    sp, stack, best_t, best_tri, pops = jax.lax.while_loop(
        cond, body, (sp, stack, best_t, best_tri, pops))
    if with_stats:
        return best_t, best_tri, pops
    return best_t, best_tri


def bvh4_closest_hit(bvh: BVH4Arrays, o, d):
    return _traverse4(bvh, o, d, any_hit=False)


def bvh4_closest_hit_stats(bvh: BVH4Arrays, o, d):
    """(t, tri, pops[N]): per-lane node-visit counts — the batched analog
    of the reference's per-object intersection-test counters
    (intersect.h:363-364, shapes/shapes.cpp:3-6). Diagnostics path; the
    production traversal carries no counter."""
    return _traverse4(bvh, o, d, any_hit=False, with_stats=True)


def bvh4_any_hit(bvh: BVH4Arrays, o, d, max_dist):
    t, _ = _traverse4(bvh, o, d, any_hit=True, max_dist=max_dist)
    return t
