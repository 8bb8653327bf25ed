"""4-wide fat-row BVH over SPHERES — acceleration for analytic primitives.

The reference's grid/BVH index ALL object types through per-object AABBs
(getObjectAABB, shapes/shapes.cpp:141; scene/scenedata.h:12-18); round 1
brute-forced every analytic primitive per ray per bounce, O(N*M) on
sphere-heavy scenes. This module gives spheres the same fat-row treatment
as triangles (accel/bvh4.py): the host binary-BVH builder only consumes
the min/max/centroid of its three input points, so each sphere's AABB
corners + center are fed to it as a degenerate "triangle" — zero new
build code — and each 4-wide node row inlines its leaf spheres
(center[3], radius, phi, min_theta, max_theta, id), one gather per
traversal step.

Leaf test = the partial-sphere quadratic with the reference's clip
conventions (sphere.cpp:33-86): phi = atan2(x, z), REJECT on
|cos theta| > 1 (the unclamped-acos NaN quirk), both roots tried.
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax
import jax.numpy as jnp
import numpy as np

from craytracer_tpu.constants import K_EPSILON, TMAX
from craytracer_tpu.core import math as vm
from craytracer_tpu.accel.bvh import LEAF_SIZE, MAX_STACK
from craytracer_tpu.accel.bvh4 import WIDTH, collapse4

_SPH_COLS = 8  # center 3, radius, phi, min_theta, max_theta, id
_SPH0 = 28  # cols 0:24 child boxes, 24:28 child ids
SPH_FAT_WIDTH = _SPH0 + WIDTH * LEAF_SIZE * _SPH_COLS


@struct.dataclass
class SphereBVH4:
    fat: jnp.ndarray  # [M, >=28 + 4*leaf_size*8] (padded to 128 cols)
    n_prims: int = struct.field(pytree_node=False, default=0)
    # leaf_size=2 keeps rows at 92 cols (one 128-column row)
    leaf_size: int = struct.field(pytree_node=False, default=LEAF_SIZE)
    # Static per-tree stack bound; stack stored [S, N] (see bvh4.BVH4Arrays).
    stack_size: int = struct.field(pytree_node=False, default=MAX_STACK)


def build_bvh4_spheres(center: np.ndarray, radius: np.ndarray,
                       phi: np.ndarray, min_theta: np.ndarray,
                       max_theta: np.ndarray,
                       leaf_size: int = LEAF_SIZE) -> SphereBVH4:
    center = np.asarray(center, np.float64)
    radius = np.asarray(radius, np.float64)
    p = center.shape[0]
    if p == 0 or p >= (1 << 24):
        raise ValueError("sphere BVH needs 1..2^24-1 spheres")
    bb_min = center - radius[:, None]
    bb_max = center + radius[:, None]
    # the binary builder uses only min/max/centroid of its three points
    mins, maxs, child, lf, lc, order, _, _, _ = collapse4(
        bb_min, bb_max, center, leaf_size)
    m = mins.shape[0]

    rows = np.concatenate([
        center, radius[:, None], np.asarray(phi, np.float64)[:, None],
        np.asarray(min_theta, np.float64)[:, None],
        np.asarray(max_theta, np.float64)[:, None],
        np.arange(p, dtype=np.float64)[:, None],
    ], axis=1)[order.astype(np.int64)]  # leaf order

    slots = lf[:, :, None] + np.arange(leaf_size)[None, None, :]
    ok = (lf[:, :, None] >= 0) & (np.arange(leaf_size)[None, None, :] < lc[:, :, None])
    pad = np.zeros(_SPH_COLS, np.float64)
    pad[-1] = -1.0  # id -1 guards; radius 0 never hits
    blocks = np.where(ok[..., None], rows[np.clip(slots, 0, p - 1)], pad)
    fat = np.concatenate([
        mins.reshape(m, 12), maxs.reshape(m, 12), child.astype(np.float64),
        blocks.reshape(m, WIDTH * leaf_size * _SPH_COLS),
    ], axis=1).astype(np.float32)
    from craytracer_tpu.accel.bvh4 import _pad128, stack_bound_children

    return SphereBVH4(fat=jnp.asarray(_pad128(fat)), n_prims=p,
                      leaf_size=leaf_size,
                      stack_size=stack_bound_children(child))


def _traverse_s(bvh: SphereBVH4, o, d, any_hit: bool, max_dist=None):
    n = o.shape[0]
    inv_d = 1.0 / vm._safe(d)
    if max_dist is None:
        max_dist = jnp.full((n,), TMAX)

    # [S, n] stack, S a per-tree static bound (see bvh4.BVH4Arrays).
    S = int(getattr(bvh, "stack_size", MAX_STACK))
    stack = jnp.zeros((S, n), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)
    best_t = jnp.full((n,), TMAX)
    best_prim = jnp.full((n,), -1, jnp.int32)
    n_nodes = bvh.fat.shape[0]
    k_slots = WIDTH * bvh.leaf_size

    def cond(state):
        sp, *_ = state
        return jnp.any(sp > 0)

    iota_s = jnp.arange(S, dtype=jnp.int32)[:, None]

    def body(state):
        sp, stack, best_t, best_prim = state
        active = sp > 0
        # dense pop (see bvh4._traverse4: one gather per step)
        top = sp - 1
        node = jnp.sum(jnp.where(iota_s == top[None, :], stack, 0), axis=0)
        sp = jnp.where(active, top, sp)
        node_c = jnp.where(active, jnp.clip(node, 0, n_nodes - 1), 0)

        row = jnp.take(bvh.fat, node_c, axis=0)  # THE gather

        # Unrolled to pure [N] vectors (see bvh4._traverse4).
        colf = lambda j: row[:, j]  # noqa: E731
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        ivx, ivy, ivz = inv_d[:, 0], inv_d[:, 1], inv_d[:, 2]

        tlimit = jnp.minimum(best_t, max_dist)
        tn_c, box_hit_c, child_c = [], [], []
        for c4 in range(WIDTH):
            t0x = (colf(c4 * 3 + 0) - ox) * ivx
            t1x = (colf(12 + c4 * 3 + 0) - ox) * ivx
            t0y = (colf(c4 * 3 + 1) - oy) * ivy
            t1y = (colf(12 + c4 * 3 + 1) - oy) * ivy
            t0z = (colf(c4 * 3 + 2) - oz) * ivz
            t1z = (colf(12 + c4 * 3 + 2) - oz) * ivz
            tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                         jnp.minimum(t0y, t1y)),
                             jnp.minimum(t0z, t1z))
            tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                         jnp.maximum(t0y, t1y)),
                             jnp.maximum(t0z, t1z))
            tn_c.append(tn)
            box_hit_c.append(active & (tn <= tf) & (tf > 0.0) & (tn < tlimit))
            child_c.append(colf(24 + c4).astype(jnp.int32))

        # Inlined leaf spheres, tested unconditionally (pads have radius 0
        # and id -1 and can never produce a valid hit).
        for k in range(k_slots):
            s0 = _SPH0 + k * _SPH_COLS
            pcx, pcy, pcz = colf(s0 + 0), colf(s0 + 1), colf(s0 + 2)
            pr = colf(s0 + 3)
            pphi = colf(s0 + 4)
            pth0 = colf(s0 + 5)
            pth1 = colf(s0 + 6)
            pid = colf(s0 + 7).astype(jnp.int32)
            ocx, ocy, ocz = ox - pcx, oy - pcy, oz - pcz
            b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
            c = ocx * ocx + ocy * ocy + ocz * ocz - pr * pr
            disc = b * b - 4.0 * c  # a == 1 for unit directions
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            hit_any = disc > 0.0

            def accept(tt):
                hpx = ocx + tt * dx
                hpy = ocy + tt * dy
                hpz = ocz + tt * dz
                phi = jnp.arctan2(hpx, hpz)
                cos_raw = hpy / jnp.maximum(pr, 1e-12)
                theta = jnp.arccos(jnp.clip(cos_raw, -1.0, 1.0))
                ok = (hit_any & (pid >= 0) & (tt > K_EPSILON)
                      & (jnp.abs(phi) <= pphi)
                      & (theta >= pth0) & (theta <= pth1)
                      & (jnp.abs(cos_raw) <= 1.0)  # reference acos-NaN reject
                      & (tt < best_t))
                if any_hit:
                    ok = ok & (tt < max_dist)
                return jnp.where(ok, tt, TMAX)

            tt = jnp.minimum(accept((-b - sq) * 0.5), accept((-b + sq) * 0.5))
            better = tt < best_t
            best_t = jnp.where(better, tt, best_t)
            best_prim = jnp.where(better, pid, best_prim)

        is_int_child = [(child_c[c4] >= 0) & box_hit_c[c4]
                        for c4 in range(WIDTH)]

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
        cval = kc[1]
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
        return sp, stack, best_t, best_prim

    sp, stack, best_t, best_prim = jax.lax.while_loop(
        cond, body, (sp, stack, best_t, best_prim))
    return best_t, best_prim


def bvh4s_closest_hit(bvh: SphereBVH4, o, d):
    return _traverse_s(bvh, o, d, any_hit=False)


def bvh4s_any_hit(bvh: SphereBVH4, o, d, max_dist):
    t, _ = _traverse_s(bvh, o, d, any_hit=True, max_dist=max_dist)
    return t
