"""Binned-treelet traversal: a gather-free, block-synchronous BVH walk.

The reference walks a QBVH one ray per CPU thread with per-node pointer
chasing (accelerator/bvh4.h:299-389). In the batched fat-row traversal
(accel/bvh4.py) per-lane node fetches are gathers, one per serial step,
and ~100 serial steps set the wall time however little compute each
does. This module removes the per-step gather entirely:

  BUILD  Cut the binary BVH into TREELETS of <= L triangles (subtree
         cuts, so every treelet's triangles are CONTIGUOUS in the DFS
         triangle order). Keep each treelet's tris padded to a fixed
         L-row stride, plus one AABB per treelet. A scene becomes
         T treelet boxes + a [T*L] triangle pool — no node gathers left.

  TRACE  Per 2048-ray block (lax.scan over blocks), loop rounds:
           1. candidate pass — dense [B, T] slab test against ALL
              treelet boxes; each lane picks its SMALLEST needed treelet
              id above the block cursor (needed = box hit with entry
              t < best_t). Dense elementwise work, T in the minor dim.
           2. block vote — the minimum candidate id over the block; ONE
              dynamic_slice fetches K consecutive treelets' K*L
              triangles starting there (sequential read, no gather).
           3. dense Moller-Trumbore [B, K*L]; the BLOCK cursor jumps
              past the K tested ids for every lane, best_t tightens,
              and lanes retire when no needed id remains.
         A block finishes when no lane has a candidate left. Correctness
         does not depend on visit order: a treelet is skipped only when
         its entry distance can't beat the lane's current best_t, and
         best_t only tightens — the classic closest-hit pruning
         invariant, order-free. The ascending-id cursor makes rounds
         EXACTLY ceil(union-span / K): monotone, no per-lane
         interleaving (a (t_entry, id)-ordered cursor variant measured
         16x WORSE — lanes advanced one id at a time, out of sync).

Every hot loop is a dense [B, 128k] vector op — no gathers, no scalar
control per lane. The cost model is pure flops: visits/ray *
(T*25 + L*35) flops. Coherent blocks vote few distinct treelets; pair
with ops/raysort for bounce rays. (Designed for the previous
accelerator; not yet measured on the GPU.)

Deviation: the reference has no analog — this is a re-design for the
gather cost model, equivalent in results to bvh4_closest_hit/any_hit.
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax
import jax.numpy as jnp
import numpy as np

from craytracer_tpu.constants import K_EPSILON, TMAX
from craytracer_tpu.core import math as vm

_BIG = 3.0e38
DEFAULT_L = 512          # triangles per treelet (padded stride)
DEFAULT_BLOCK = 2048     # rays per scanned block


@struct.dataclass
class BinnedArrays:
    """Treelet-cut scene: T boxes + a [T*L] padded triangle pool.

    When built with mxu=True the MT test runs in MATMUL form: the
    Moller-Trumbore numerators are BILINEAR in (o, d) —
        det       = d . (e2 x e1)
        beta_num  = (o' x d) . e2  +  d . (v0' x e2)
        gamma_num = -(o' x d) . e1 +  d . (e1 x v0')
        t_num     = o' . (e1 x e2) -  v0' . (e1 x e2)
    with o' = o - c, v0' = v0 - c re-centered on the treelet box center c
    (bounding the expansion's cancellation to the treelet's extent). So a
    10-feature ray vector F = [o'xd, d, o', 1] against per-triangle
    coefficient columns gives all four numerators as ONE
    [B,10] @ [10,4L] matmul; the elementwise epilogue is just inv_det
    scaling, the barycentric window test, and the min-reduce."""
    box_min: jnp.ndarray   # [3, Tpad] per-axis rows (lane-dense minor dim)
    box_max: jnp.ndarray   # [3, Tpad]
    tris: jnp.ndarray      # [10, T*L]: v0 xyz, e1 xyz, e2 xyz, orig id
    centers: jnp.ndarray | None = None   # [3, Tpad] treelet box centers
    coef: jnp.ndarray | None = None      # [10, T*4L] MXU-MT coefficients
    n_treelets: int = struct.field(pytree_node=False, default=0)
    leaf_stride: int = struct.field(pytree_node=False, default=DEFAULT_L)
    n_tris: int = struct.field(pytree_node=False, default=0)


def _subtree_ranges(right, first, count):
    """Per-node (range_first, range_count) over the DFS triangle order.

    Pointer-doubling over the leftmost-/rightmost-leaf chains: O(m log d)
    numpy, no Python loop over nodes (San-Miguel trees have ~3.5M nodes).
    """
    m = right.shape[0]
    is_leaf = count > 0
    idx = np.arange(m, dtype=np.int64)
    left_chain = np.where(is_leaf, idx, idx + 1)    # leaf: self; else left child
    right_chain = np.where(is_leaf, idx, right.astype(np.int64))
    lmost = left_chain.copy()
    rmost = right_chain.copy()
    for _ in range(64):
        nl = lmost[lmost]
        nr = rmost[rmost]
        if np.array_equal(nl, lmost) and np.array_equal(nr, rmost):
            break
        lmost, rmost = nl, nr
    rfirst = first[lmost].astype(np.int64)
    rend = (first[rmost] + count[rmost]).astype(np.int64)
    return rfirst, rend - rfirst


def _treelet_cut(node_min, node_max, right, first, count, L):
    """Subtree cut with <= L tris per treelet; returns per-treelet
    (box_min, box_max, tri_first, tri_count) sorted by tri_first."""
    m = right.shape[0]
    rfirst, rcount = _subtree_ranges(right, first, count)
    is_leaf = count > 0
    small = (rcount <= L) | is_leaf
    parent = np.full(m, -1, np.int64)
    internal = np.flatnonzero(~is_leaf)
    parent[internal + 1] = internal
    parent[right[internal]] = internal
    # a treelet root is a small node whose parent is big (or the root);
    # descendants of small nodes are excluded by checking the parent.
    parent_big = np.where(parent >= 0, ~small[np.maximum(parent, 0)], True)
    roots = np.flatnonzero(small & parent_big)
    o = np.argsort(rfirst[roots], kind="stable")
    roots = roots[o]
    return (node_min[roots], node_max[roots], rfirst[roots], rcount[roots])


def _mxu_coefs(pool, bmin, bmax, T, L):
    """Per-triangle MXU-MT coefficient columns (see BinnedArrays): returns
    (centers [T,3], coef [10, T*4L]) with outputs blocked [det|beta|gamma|t]
    per treelet so a [10, 4L] slice feeds one matmul."""
    c = ((bmin + bmax) * 0.5).astype(np.float32)          # [T, 3]
    v0p = pool[:, 0:3].reshape(T, L, 3) - c[:, None, :]
    e1 = pool[:, 3:6].reshape(T, L, 3)
    e2 = pool[:, 6:9].reshape(T, L, 3)
    m = np.cross(e1, e2)
    coef = np.zeros((T, 4, L, 10), np.float32)
    coef[:, 0, :, 3:6] = np.cross(e2, e1)                 # det = d.(e2 x e1)
    coef[:, 1, :, 0:3] = e2                               # beta: w'.e2
    coef[:, 1, :, 3:6] = np.cross(v0p, e2)                # + d.(v0' x e2)
    coef[:, 2, :, 0:3] = -e1                              # gamma: -w'.e1
    coef[:, 2, :, 3:6] = np.cross(e1, v0p)                # + d.(e1 x v0')
    coef[:, 3, :, 6:9] = m                                # t: o'.m
    coef[:, 3, :, 9] = -np.einsum("tlk,tlk->tl", v0p, m)  # - v0'.m
    coef = coef.reshape(T, 4 * L, 10).transpose(2, 0, 1).reshape(10, -1)
    return c, np.ascontiguousarray(coef)


def build_binned(v0, v1, v2, L: int = DEFAULT_L,
                 split: str = "sah", mxu: bool = True) -> BinnedArrays:
    """Build the treelet cut from a binary BVH (native SAH when available)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    if t == 0:
        tris = np.zeros((10, L), np.float32)
        tris[9] = -1.0
        return BinnedArrays(
            box_min=jnp.asarray(np.ones((3, 128), np.float32)),
            box_max=jnp.asarray(-np.ones((3, 128), np.float32)),
            tris=jnp.asarray(tris), n_treelets=0, leaf_stride=L, n_tris=0)

    from craytracer_tpu.native import build_bvh_native

    nat = build_bvh_native(v0, v1, v2, 4, split)
    if nat is None:
        from craytracer_tpu.accel.bvh import _build_arrays

        nodes, order_l = _build_arrays(v0, v1, v2, 4)
        node_min = np.stack([n["min"] for n in nodes]).astype(np.float32)
        node_max = np.stack([n["max"] for n in nodes]).astype(np.float32)
        right = np.asarray([n["right"] for n in nodes], np.int32)
        first = np.asarray([n["first"] for n in nodes], np.int32)
        count = np.asarray([n["count"] for n in nodes], np.int32)
        order = np.asarray(order_l, np.int32)
    else:
        node_min, node_max, right, _axis, first, count, order = nat

    bmin, bmax, tfirst, tcount = _treelet_cut(
        node_min, node_max, right, first, count, L)
    T = bmin.shape[0]

    # padded triangle pool: treelet k owns rows [k*L, (k+1)*L)
    order64 = order.astype(np.int64)
    pv0 = v0[order64]
    pe1 = v1[order64] - v0[order64]
    pe2 = v2[order64] - v0[order64]
    rows = np.concatenate(
        [pv0, pe1, pe2, order.astype(np.float32)[:, None]], axis=1)  # [t,10]
    pool = np.zeros((T * L, 10), np.float32)
    pool[:, 9] = -1.0                      # pad id -1: never hits
    dst = (np.arange(T)[:, None] * L + np.arange(L)[None, :])  # [T, L]
    src = tfirst[:, None] + np.arange(L)[None, :]
    valid = np.arange(L)[None, :] < tcount[:, None]
    pool[dst[valid]] = rows[src[valid]]

    Tpad = max(128, ((T + 127) // 128) * 128)
    bmin_p = np.ones((Tpad, 3), np.float32)
    bmax_p = -np.ones((Tpad, 3), np.float32)
    bmin_p[:T] = bmin
    bmax_p[:T] = bmax
    centers = coef = None
    if mxu:
        c, coef_np = _mxu_coefs(pool, bmin.astype(np.float32),
                                bmax.astype(np.float32), T, L)
        cp = np.zeros((Tpad, 3), np.float32)
        cp[:T] = c
        centers = jnp.asarray(cp.T.copy())
        coef = jnp.asarray(coef_np)
    return BinnedArrays(
        box_min=jnp.asarray(bmin_p.T.copy()),
        box_max=jnp.asarray(bmax_p.T.copy()),
        tris=jnp.asarray(pool.T.copy()),
        centers=centers, coef=coef,
        n_treelets=T, leaf_stride=L, n_tris=t)


def _trace_block(acc: BinnedArrays, o, d, inv_d, max_dist, any_hit: bool,
                 k_fetch: int = 2, mxu: bool = False,
                 precision=None):
    """One ray block to completion. o/d/inv_d: [3, B]; max_dist: [B]."""
    B = o.shape[1]
    T = acc.n_treelets
    Tpad = acc.box_min.shape[1]
    L = acc.leaf_stride
    iota_t = jax.lax.broadcasted_iota(jnp.int32, (1, Tpad), 1)

    ox, oy, oz = o[0][:, None], o[1][:, None], o[2][:, None]      # [B,1]
    dx, dy, dz = d[0][:, None], d[1][:, None], d[2][:, None]
    ivx, ivy, ivz = inv_d[0][:, None], inv_d[1][:, None], inv_d[2][:, None]
    if mxu:
        # per-ray o x d, re-centered per treelet each round (see
        # BinnedArrays docstring)
        w0x = o[1] * d[2] - o[2] * d[1]
        w0y = o[2] * d[0] - o[0] * d[2]
        w0z = o[0] * d[1] - o[1] * d[0]

    def _slab(bm, bx):
        """(tn, tf) of the rays vs boxes given as [3, W] column arrays."""
        t0x = (bm[0][None, :] - ox) * ivx
        t1x = (bx[0][None, :] - ox) * ivx
        t0y = (bm[1][None, :] - oy) * ivy
        t1y = (bx[1][None, :] - oy) * ivy
        t0z = (bm[2][None, :] - oz) * ivz
        t1z = (bx[2][None, :] - oz) * ivz
        tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                     jnp.minimum(t0y, t1y)),
                         jnp.minimum(t0z, t1z))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                     jnp.maximum(t0y, t1y)),
                         jnp.maximum(t0z, t1z))
        return tn, tf

    def candidates(cursor, best_t):
        """Dense [B, Tpad] slab pass -> each lane's smallest needed
        treelet id above the block cursor, or Tpad when none remains.

        Recomputed fresh every round: both a loop-invariant bf16 key
        cache (3-4x slower — per-round layout conversion) and a
        two-level supertreelet scheme (extra scalar-vector sync chains)
        measured WORSE than this straight dense recompute.

        iota_t < T guards the pad slots: their (min=1, max=-1) corners
        would otherwise NORMALIZE through the slab min/max into a
        phantom [-1,1]^3 box (measured: 5x the round count)."""
        tn, tf = _slab(acc.box_min, acc.box_max)
        needed = ((tn <= tf) & (tf > 0.0)
                  & (jnp.maximum(tn, 0.0) < best_t[:, None])
                  & (iota_t > cursor) & (iota_t < T))
        return jnp.min(jnp.where(needed, iota_t, Tpad), axis=1)

    def mt_treelets_mxu(tsel, best_t, best_tri):
        """Matmul path: per fetched treelet, numerators via ONE
        [B,10] @ [10,4L] matmul; elementwise epilogue only."""
        dets, betas, gammas, tts = [], [], [], []
        for i in range(k_fetch):
            ts = tsel + i
            c = jax.lax.dynamic_slice(acc.centers, (0, ts), (3, 1))
            cx, cy, cz = c[0, 0], c[1, 0], c[2, 0]
            wx = w0x - (cy * d[2] - cz * d[1])
            wy = w0y - (cz * d[0] - cx * d[2])
            wz = w0z - (cx * d[1] - cy * d[0])
            F = jnp.stack([wx, wy, wz, d[0], d[1], d[2],
                           o[0] - cx, o[1] - cy, o[2] - cz,
                           jnp.ones_like(wx)], axis=1)        # [B, 10]
            C = jax.lax.dynamic_slice(acc.coef, (0, ts * 4 * L), (10, 4 * L))
            out = jax.lax.dot_general(
                F, C, (((1,), (0,)), ((), ())),
                precision=precision or jax.lax.Precision.HIGHEST)
            dets.append(out[:, 0:L])
            betas.append(out[:, L:2 * L])
            gammas.append(out[:, 2 * L:3 * L])
            tts.append(out[:, 3 * L:4 * L])
        det = jnp.concatenate(dets, axis=1)
        beta_num = jnp.concatenate(betas, axis=1)
        gamma_num = jnp.concatenate(gammas, axis=1)
        tt_num = jnp.concatenate(tts, axis=1)
        tid = jax.lax.dynamic_slice(
            acc.tris, (9, tsel * L), (1, k_fetch * L)).astype(jnp.int32)
        inv_det = 1.0 / vm._safe(det)
        beta = beta_num * inv_det
        gamma = gamma_num * inv_det
        tt = tt_num * inv_det
        ok = ((tid >= 0) & (beta >= 0.0) & (gamma >= 0.0)
              & (beta + gamma <= 1.0) & (tt > K_EPSILON)
              & (tt < best_t[:, None]))
        if any_hit:
            ok = ok & (tt < max_dist[:, None])
        val = jnp.where(ok, tt, _BIG)
        won = jnp.min(val, axis=1)
        wid = jnp.min(jnp.where(val == won[:, None],
                                jnp.broadcast_to(tid, val.shape), 1 << 30),
                      axis=1)
        upd = won < _BIG
        return (jnp.where(upd, won, best_t),
                jnp.where(upd, wid, best_tri))

    def mt_treelets(tsel, best_t, best_tri):
        """Dense [B, k_fetch*L] Moller-Trumbore vs treelets
        [tsel, tsel+k_fetch)'s padded tris."""
        if mxu:
            return mt_treelets_mxu(tsel, best_t, best_tri)
        tri = jax.lax.dynamic_slice(acc.tris, (0, tsel * L),
                                    (10, k_fetch * L))
        v0x, v0y, v0z = tri[0][None, :], tri[1][None, :], tri[2][None, :]
        e1x, e1y, e1z = tri[3][None, :], tri[4][None, :], tri[5][None, :]
        e2x, e2y, e2z = tri[6][None, :], tri[7][None, :], tri[8][None, :]
        tid = tri[9].astype(jnp.int32)[None, :]
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
        ok = ((tid >= 0) & (beta >= 0.0) & (gamma >= 0.0)
              & (beta + gamma <= 1.0) & (tt > K_EPSILON)
              & (tt < best_t[:, None]))
        if any_hit:
            ok = ok & (tt < max_dist[:, None])
        val = jnp.where(ok, tt, _BIG)
        won = jnp.min(val, axis=1)
        # winner id by min-fold (no gather); ties at identical t pick the
        # smallest original id — consistent across calls
        wid = jnp.min(jnp.where(val == won[:, None], tid, 1 << 30), axis=1)
        upd = won < _BIG
        return (jnp.where(upd, won, best_t),
                jnp.where(upd, wid, best_tri))

    best_t0 = jnp.minimum(jnp.full((B,), TMAX), max_dist) if any_hit \
        else jnp.full((B,), TMAX)
    # any-hit: candidate pruning uses best_t, seeded at max_dist so boxes
    # beyond the light are never visited; a found hit sets best_t < seed.

    def _prune(best_t, best_tri):
        # any-hit lanes retire outright once occluded (prune bound 0)
        return jnp.where(best_tri >= 0, 0.0, best_t) if any_hit else best_t

    cand0 = candidates(jnp.int32(-1), best_t0)
    state0 = (jnp.int32(-1), best_t0,
              jnp.full((B,), -1, jnp.int32), cand0)

    def cond(s):
        _, _, _, cand = s
        return jnp.min(cand) < Tpad

    def body(s):
        cursor, best_t, best_tri, cand = s
        blockmin = jnp.min(cand)
        tsel = jnp.clip(blockmin, 0, max(T - 1, 0))
        best_t, best_tri = mt_treelets(tsel, best_t, best_tri)
        # every lane's needed ids in [blockmin, blockmin+k_fetch) were
        # tested (MT needs no box gate: any tt < best_t is a real hit),
        # and ids in (cursor, blockmin) were needed by nobody.
        cursor = blockmin + (k_fetch - 1)
        cand = candidates(cursor, _prune(best_t, best_tri))
        return cursor, best_t, best_tri, cand

    s = jax.lax.while_loop(cond, body, state0)
    best_t, best_tri = s[1], s[2]
    if any_hit:
        # report TMAX when nothing beat max_dist (bvh4_any_hit semantics)
        best_t = jnp.where(best_tri >= 0, best_t, TMAX)
    return best_t, best_tri


def _trace(acc: BinnedArrays, o, d, any_hit: bool, max_dist=None,
           block: int = DEFAULT_BLOCK, k_fetch: int = 2,
           mxu: bool = False, precision=None):
    mxu = mxu and acc.coef is not None
    n = o.shape[0]
    if acc.n_treelets == 0 or acc.n_tris == 0:
        t = jnp.full((n,), TMAX)
        return t if any_hit else (t, jnp.full((n,), -1, jnp.int32))
    if max_dist is None:
        max_dist = jnp.full((n,), TMAX)
    b = min(block, max(128, ((n + 127) // 128) * 128))
    pad = (-n) % b
    ot = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)]).T  # [3, n+pad]
    dt = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)]).T
    md = jnp.concatenate([max_dist, jnp.zeros((pad,), max_dist.dtype)])
    ivt = 1.0 / vm._safe(dt.T).T
    nb = (n + pad) // b
    obl = ot.reshape(3, nb, b).transpose(1, 0, 2)
    dbl = dt.reshape(3, nb, b).transpose(1, 0, 2)
    ivbl = ivt.reshape(3, nb, b).transpose(1, 0, 2)
    mdbl = md.reshape(nb, b)

    def step(_, xs):
        ob, db, ivb, mdb = xs
        t, tri = _trace_block(acc, ob, db, ivb, mdb, any_hit,
                              k_fetch=min(k_fetch, max(acc.n_treelets, 1)),
                              mxu=mxu, precision=precision)
        return None, (t, tri)

    _, (t, tri) = jax.lax.scan(step, None, (obl, dbl, ivbl, mdbl))
    t = t.reshape(-1)[:n]
    tri = tri.reshape(-1)[:n]
    return t if any_hit else (t, tri)


def binned_closest_hit(acc: BinnedArrays, o, d, block: int = DEFAULT_BLOCK,
                       k_fetch: int = 2, mxu: bool = False, precision=None):
    """Drop-in for bvh4_closest_hit: (t, tri) with TMAX/-1 misses."""
    return _trace(acc, o, d, any_hit=False, block=block, k_fetch=k_fetch,
                  mxu=mxu, precision=precision)


def binned_any_hit(acc: BinnedArrays, o, d, max_dist,
                   block: int = DEFAULT_BLOCK, k_fetch: int = 2,
                   mxu: bool = False, precision=None):
    """Drop-in for bvh4_any_hit: t < max_dist iff occluded."""
    return _trace(acc, o, d, any_hit=True, max_dist=max_dist, block=block,
                  k_fetch=k_fetch, mxu=mxu, precision=precision)
