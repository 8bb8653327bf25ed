"""Quantized 4-wide BVH: u8 child bounds decoded against parent boxes.

Implements the memory-traffic reduction of "Minimizing Ray Tracing Memory
Traffic through Quantized Structures and Ray Stream Tracing" (PAPERS.md):
each node stores its own bounds in f32 once, and its 4 children's boxes as
u8 offsets within them. Quantization is conservative with a one-step pad
(floor the mins then subtract 1, ceil the maxs then add 1, clamped to
[0,255]) so f32 rounding in the rel-coordinate division can never shrink a
child box across a quantization boundary — traversal visits a strict
superset of the exact-BVH nodes and returns identical hits.

Same FAT-ROW single-gather-per-step design as accel/bvh4.py,
with the 4 children's 24 u8 box bytes bit-packed into 6 u32 columns
(bitcast to f32 for storage, decoded with shifts after the gather).

Not a performance feature: at the production leaf_size=2 the quantized
row is 96 columns vs bvh4's 108, both within one 128-column row, so the
quantization saves little traffic and the in-register shift/and decode
is extra work. The backend stays for parity with the reference's QBVH
compression intent (accelerator/bvh4.h:100-110); accel='auto' never
selects bvh4q. (Not measured on the GPU.)
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax
import jax.numpy as jnp
import numpy as np

from craytracer_tpu.constants import K_EPSILON, TMAX
from craytracer_tpu.core import math as vm
from craytracer_tpu.accel.bvh import LEAF_SIZE, MAX_STACK
from craytracer_tpu.accel.bvh4 import WIDTH, _TRI_COLS, collapse4

_Q_TRI0 = 16  # cols: node_min 3, node_scale 3, child 4, packed boxes 6
QFAT_WIDTH = _Q_TRI0 + WIDTH * LEAF_SIZE * _TRI_COLS


@struct.dataclass
class BVH4QArrays:
    fat: jnp.ndarray  # [M, >=16 + 4*leaf_size*10] (padded to 128 cols)
    n_tris: int = struct.field(pytree_node=False, default=0)
    # leaf_size=2 keeps the row at 96 cols: single-index gathers above 128
    # f32 cols are ~4.5x slower (profiling/ablate_fat_gather.py)
    leaf_size: int = struct.field(pytree_node=False, default=LEAF_SIZE)
    # Static per-tree stack bound; stack stored [S, N] (see bvh4.BVH4Arrays).
    stack_size: int = struct.field(pytree_node=False, default=MAX_STACK)


def build_bvh4q(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                leaf_size: int = LEAF_SIZE) -> BVH4QArrays:
    from craytracer_tpu.accel.bvh4 import _pad128

    t = np.asarray(v0).shape[0]
    if t == 0:
        fat = np.zeros((1, _Q_TRI0 + WIDTH * leaf_size * _TRI_COLS),
                       np.float32)
        fat[:, 6:10] = -1.0
        fat[:, _Q_TRI0 + _TRI_COLS - 1::_TRI_COLS] = -1.0
        return BVH4QArrays(fat=jnp.asarray(_pad128(fat)), n_tris=0,
                           leaf_size=leaf_size, stack_size=16)
    if t >= (1 << 24):
        raise ValueError("fat-row BVH4Q inlines f32 triangle ids; "
                         "triangle count must stay below 2^24")
    cmin, cmax, child, lf, lc, order, pv0, pe1, pe2 = collapse4(
        v0, v1, v2, leaf_size)
    m = cmin.shape[0]
    valid = (child >= 0) | (lc > 0)  # [M, 4]

    # parent bounds = union of valid child boxes
    big = np.where(valid[..., None], cmin, np.inf)
    node_min = np.min(big, axis=1)
    big = np.where(valid[..., None], cmax, -np.inf)
    node_max = np.max(big, axis=1)
    empty = ~valid.any(axis=1)
    node_min[empty] = 0.0
    node_max[empty] = 1.0
    extent = np.maximum(node_max - node_min, 1e-12)
    scale = (extent / 255.0).astype(np.float32)

    rel_min = (cmin - node_min[:, None, :]) / scale[:, None, :]
    rel_max = (cmax - node_min[:, None, :]) / scale[:, None, :]
    # one-step conservative pad: f32 rounding in the division above may
    # floor/ceil across an integer boundary (ADVICE.md round 1)
    qmin = np.clip(np.floor(rel_min) - 1, 0, 255).astype(np.uint32)
    qmax = np.clip(np.ceil(rel_max) + 1, 0, 255).astype(np.uint32)
    # invalid (empty) slots: inverted boxes that never hit
    qmin = np.where(valid[..., None], qmin, 255).astype(np.uint32)
    qmax = np.where(valid[..., None], qmax, 0).astype(np.uint32)

    # pack: u32[c] = qmin.x|y<<8|z<<16|qmax.x<<24 (c = child 0..3),
    # u32[4] = 4 children's qmax.y, u32[5] = 4 children's qmax.z
    packed = np.zeros((m, 6), np.uint32)
    for c in range(WIDTH):
        packed[:, c] = (qmin[:, c, 0] | (qmin[:, c, 1] << 8)
                        | (qmin[:, c, 2] << 16) | (qmax[:, c, 0] << 24))
        packed[:, 4] |= qmax[:, c, 1] << (8 * c)
        packed[:, 5] |= qmax[:, c, 2] << (8 * c)

    tri_rows = np.concatenate(
        [pv0, pe1, pe2, order.astype(np.float32)[:, None]], axis=1)
    slots = lf[:, :, None] + np.arange(leaf_size)[None, None, :]
    ok = (lf[:, :, None] >= 0) & (np.arange(leaf_size)[None, None, :] < lc[:, :, None])
    pad = np.zeros(_TRI_COLS, np.float32)
    pad[-1] = -1.0
    blocks = np.where(ok[..., None], tri_rows[np.clip(slots, 0, t - 1)], pad)
    fat = np.concatenate([
        node_min.astype(np.float32), scale, child.astype(np.float32),
        packed.view(np.float32),
        blocks.reshape(m, WIDTH * leaf_size * _TRI_COLS),
    ], axis=1).astype(np.float32)
    from craytracer_tpu.accel.bvh4 import stack_bound_children

    return BVH4QArrays(fat=jnp.asarray(_pad128(fat)), n_tris=t,
                       leaf_size=leaf_size,
                       stack_size=stack_bound_children(child))


def _traverse4q(bvh: BVH4QArrays, o, d, any_hit: bool, max_dist=None):
    n = o.shape[0]
    inv_d = 1.0 / vm._safe(d)
    if max_dist is None:
        max_dist = jnp.full((n,), TMAX)

    # [S, n] stack, S a per-tree static bound (see bvh4.BVH4Arrays).
    S = int(getattr(bvh, "stack_size", MAX_STACK))
    stack = jnp.zeros((S, n), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)
    best_t = jnp.full((n,), TMAX)
    best_tri = jnp.full((n,), -1, jnp.int32)
    n_nodes = bvh.fat.shape[0]
    k_slots = WIDTH * bvh.leaf_size

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
        nminx, nminy, nminz = col(0), col(1), col(2)
        nsx, nsy, nsz = col(3), col(4), col(5)
        packed = jax.lax.bitcast_convert_type(row[:, 10:16], jnp.uint32)
        pky, pkz = packed[:, 4], packed[:, 5]

        def u8(w, s):
            return ((w >> np.uint32(s)) & np.uint32(0xFF)).astype(jnp.float32)

        tlimit = jnp.minimum(best_t, max_dist)
        tn_c, box_hit_c, child_c = [], [], []
        for c in range(WIDTH):
            pc = packed[:, c]
            cminx = nminx + u8(pc, 0) * nsx
            cminy = nminy + u8(pc, 8) * nsy
            cminz = nminz + u8(pc, 16) * nsz
            cmaxx = nminx + u8(pc, 24) * nsx
            cmaxy = nminy + u8(pky, 8 * c) * nsy
            cmaxz = nminz + u8(pkz, 8 * c) * nsz
            t0x = (cminx - ox) * ivx
            t1x = (cmaxx - ox) * ivx
            t0y = (cminy - oy) * ivy
            t1y = (cmaxy - oy) * ivy
            t0z = (cminz - oz) * ivz
            t1z = (cmaxz - oz) * ivz
            tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                         jnp.minimum(t0y, t1y)),
                             jnp.minimum(t0z, t1z))
            tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                         jnp.maximum(t0y, t1y)),
                             jnp.maximum(t0z, t1z))
            tn_c.append(tn)
            box_hit_c.append(active & (tn <= tf) & (tf > 0.0) & (tn < tlimit))
            child_c.append(col(6 + c).astype(jnp.int32))

        for k in range(k_slots):
            b = _Q_TRI0 + k * _TRI_COLS
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

        is_int_child = [(child_c[c] >= 0) & box_hit_c[c]
                        for c in range(WIDTH)]

        def swap(kc, i, j):
            key, cval = kc
            do = key[i] < key[j]
            ki = jnp.where(do, key[j], key[i])
            kj = jnp.where(do, key[i], key[j])
            vi = jnp.where(do, cval[j], cval[i])
            vj = jnp.where(do, cval[i], cval[j])
            key = [ki if s == i else kj if s == j else key[s] for s in range(WIDTH)]
            cval = [vi if s == i else vj if s == j else cval[s] for s in range(WIDTH)]
            return key, cval

        kc = ([jnp.where(is_int_child[s], tn_c[s], -jnp.inf) for s in range(WIDTH)],
              [jnp.where(is_int_child[s], child_c[s], -1) for s in range(WIDTH)])
        for ij in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
            kc = swap(kc, *ij)
        cval = kc[1]  # descending by tn; valid children first
        npush = sum((c >= 0).astype(jnp.int32) for c in cval)
        npush = jnp.minimum(npush, S - sp)
        rel = iota_s - sp[None, :]
        pick = cval[0][None, :]
        for r in range(1, WIDTH):
            pick = jnp.where(rel >= r, cval[r][None, :], pick)
        stack = jnp.where((rel >= 0) & (rel < npush[None, :]), pick, stack)
        sp = sp + npush

        if any_hit:
            sp = jnp.where(best_t < max_dist, 0, sp)
        return sp, stack, best_t, best_tri

    sp, stack, best_t, best_tri = jax.lax.while_loop(
        cond, body, (sp, stack, best_t, best_tri))
    return best_t, best_tri


def bvh4q_closest_hit(bvh: BVH4QArrays, o, d):
    return _traverse4q(bvh, o, d, any_hit=False)


def bvh4q_any_hit(bvh: BVH4QArrays, o, d, max_dist):
    t, _ = _traverse4q(bvh, o, d, any_hit=True, max_dist=max_dist)
    return t
