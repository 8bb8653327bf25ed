"""Whole-pass path-tracing megakernel for brute-force scenes (Pallas on
the Triton route).

`fused_pass` / `_pass_kernel`: for scenes of at most 64 analytic
primitives (spheres, planes, rects, disks, flat triangles, instanced
AABOXes) with no accel tables, ONE launch per spp-pass runs the whole
bounce loop: camera raygen (pinhole or thin-lens), closest hit over the
primitive table (the exact ops/intersect.py *_ts + _fill_* math, in
intersect_scene's tie-break group order), shade (emitted/env add, NEE
light pick + sample, BSDF sample, Russian roulette) and the shadow any-hit.
Each program owns a block of lanes; their path state (ray, throughput,
radiance, liveness) stays in registers across all bounces instead of
round-tripping device memory between the ~300 ops of the XLA bounce.
Nothing carries between programs.

Scope (checked on the host by `fast_shade_ok`/`fast_shade_mode`):
  * all seven reference material types (MATTE incl. Oren-Nayar sigma,
    EMISSIVE, MIRROR, PLASTIC, METAL, GLASS, TRANSPARENT); microfacet rows
    must be isotropic BECKMANN (the reference's only built distribution);
    no textures;
  * lights: every row with nonzero power is a RECT or SPHERE area light
    (a constant or absent env light is allowed: its escape radiance is a
    constant; zero-power rows reproduce the XLA path's pick semantics
    exactly, including the searchsorted clip edge);
  * estimator: the reference estimator (non-MIS), no geometry sharding.

Everything mirrors the XLA path op-for-op (same formulas, same eps, same
RNG bit stream). In interpret mode the per-lane results match the XLA path
to f32 rounding (tests/test_pallas_shade.py). Compiled by Triton, the
kernel contracts multiply-adds to FMA and uses its own transcendentals, so
a few lanes can take another Russian-roulette or BSDF branch; agreement is
then statistical (see chip_smoke.py).

The kernel is FORWARD-ONLY (pallas_call has no VJP): the Renderer uses it
for forward renders on the GPU; inverse rendering keeps the differentiable
XLA path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from craytracer_tpu.constants import INV_PI, K_EPSILON, PI, TMAX, TWO_PI
from craytracer_tpu.scene import types as T

# Lanes per program of the compiled kernel, a power of two (Triton's
# block shapes are), with one warp per LANES_PER_WARP lanes (two lanes per
# thread). Chosen on an H100 from 128-1024 lanes and 4-16 warps on
# Cornell and the all-materials scene at 512^2 (PERF.md): the spread
# between choices was ~15%, 1024 lanes / 16 warps the fastest in both.
PASS_BLOCK = 1024
LANES_PER_WARP = 64

# The RNG mixer and Weyl constant are IMPORTED from the production RNG
# (plain jnp u32 ops, legal inside Pallas kernels): the kernel's bit-
# exactness contract rests on there being exactly ONE definition.
from craytracer_tpu.sampling.rng import _GOLDEN, hash_u32 as _fmix


def _normalize3(x, y, z):
    """vm.normalize, component form: zero for (near-)zero vectors."""
    n2 = x * x + y * y + z * z
    inv = jnp.where(n2 > 1e-20, 1.0 / jnp.sqrt(jnp.maximum(n2, 1e-20)), 0.0)
    return x * inv, y * inv, z * inv, n2


# ---------------------------------------------------------------------------
# Local-frame BSDF math on component vectors — verbatim ports of
# core/math.py trig and bsdf/{bxdf,microfacet,fresnel}.py formulas (same
# expression trees, same eps) so the kernels match the XLA path per-lane.

def _lf_sin_theta(z):
    return jnp.sqrt(jnp.maximum(jnp.maximum(0.0, 1.0 - z * z), 1e-16))


def _lf_cos_phi(x, z):
    s = _lf_sin_theta(z)
    return jnp.where(s < 1e-6, 1.0, jnp.clip(x / _safe_div(s), -1.0, 1.0))


def _lf_sin_phi(y, z):
    s = _lf_sin_theta(z)
    return jnp.where(s < 1e-6, 0.0, jnp.clip(y / _safe_div(s), -1.0, 1.0))


def _on_scale(wix, wiy, wiz, wox, woy, woz, a, b):
    """Oren-Nayar scalar factor (a + b max_cos sin_a tan_b) / pi
    (_oren_nayar_f, bxdf.py:123-144) on component vectors."""
    sin_ti = _lf_sin_theta(wiz)
    sin_to = _lf_sin_theta(woz)
    d_cos = (_lf_cos_phi(wix, wiz) * _lf_cos_phi(wox, woz)
             + _lf_sin_phi(wiy, wiz) * _lf_sin_phi(woy, woz))
    max_cos = jnp.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                        jnp.maximum(0.0, d_cos), 0.0)
    aci = jnp.abs(wiz)
    aco = jnp.abs(woz)
    wi_bigger = aci > aco
    sin_alpha = jnp.where(wi_bigger, sin_to, sin_ti)
    tan_beta = jnp.where(wi_bigger, sin_ti / jnp.maximum(aci, 1e-7),
                         sin_to / jnp.maximum(aco, 1e-7))
    return (a + b * max_cos * sin_alpha * tan_beta) * INV_PI


def _fb_diffuse_scale(wiz, woz):
    """FresnelBlendDiffuse_f's scalar factor (bxdf.py:151-159); multiply
    by kd*(1-ks) per channel."""
    p5 = lambda v: (v * v) * (v * v) * v
    return ((28.0 / (23.0 * PI))
            * (1.0 - p5(1.0 - 0.5 * jnp.abs(wiz)))
            * (1.0 - p5(1.0 - 0.5 * jnp.abs(woz))))


def _d_beckmann(whx, why, whz, ax):
    """distribution_d, Beckmann branch (microfacet.py:24-45), isotropic
    alpha (the gate requires alphax == alphay)."""
    a = jnp.maximum(ax, 1e-4)
    c2 = whz * whz
    t2 = jnp.maximum(0.0, 1.0 - c2) / jnp.maximum(c2, 1e-6)
    c4 = c2 * c2
    c2p = _lf_cos_phi(whx, whz) ** 2
    s2p = _lf_sin_phi(why, whz) ** 2
    finite = c4 > 1e-16  # t2 from the jnp form is always finite
    t2 = jnp.where(finite, t2, 0.0)
    c4 = jnp.where(finite, c4, 1.0)
    d = jnp.exp(-t2 * (c2p / (a * a) + s2p / (a * a))) / (PI * a * a * c4)
    return jnp.where(finite, d, 0.0)


def _lambda_beckmann(wx, wy, wz, ax):
    """distribution_lambda, Beckmann branch (microfacet.py:48-76), iso."""
    a_cl = jnp.maximum(ax, 1e-4)
    c = jnp.where(jnp.abs(wz) < 1e-3,
                  jnp.where(wz < 0.0, -1e-3, 1e-3), wz)
    abs_tan = jnp.abs(_lf_sin_theta(wz) / c)
    c2p = _lf_cos_phi(wx, wz) ** 2
    s2p = _lf_sin_phi(wy, wz) ** 2
    alpha = jnp.sqrt(jnp.maximum(c2p * a_cl * a_cl + s2p * a_cl * a_cl,
                                 1e-12))
    ar = 1.0 / jnp.maximum(alpha * abs_tan, 1e-16)
    a_c = jnp.minimum(ar, 1.6)
    return jnp.where(
        ar >= 1.6, 0.0,
        (1.0 - 1.259 * a_c + 0.396 * a_c * a_c)
        / (3.535 * a_c + 2.181 * a_c * a_c))


def _sample_wh_beckmann(wox, woy, woz, u0, u1, ax):
    """sample_wh, isotropic Beckmann (microfacet.py:89-118)."""
    a = jnp.maximum(ax, 1e-4)
    log_u = jnp.log(jnp.maximum(u0, 1e-30))
    t2 = -a * a * log_u
    phi = u1 * TWO_PI
    cos_t = 1.0 / jnp.sqrt(1.0 + t2)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 1e-12))
    whx = sin_t * jnp.cos(phi)
    why = sin_t * jnp.sin(phi)
    whz = cos_t
    flip = ~(woz * whz > 0.0)
    sgn = jnp.where(flip, -1.0, 1.0)
    return whx * sgn, why * sgn, whz * sgn


def _fr_dielectric(cos_theta_i, eta_t, eta_i):
    """fr_dielectric (fresnel.py:12-29): unpolarized, IOR swap when the
    ray arrives from inside, TIR -> 1."""
    flip = cos_theta_i < 0.0
    ei = jnp.where(flip, eta_t, eta_i)
    et = jnp.where(flip, eta_i, eta_t)
    ci = jnp.abs(cos_theta_i)
    sin_i = jnp.sqrt(jnp.maximum(1.0 - ci * ci, 1e-12))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = jnp.sqrt(jnp.maximum(1.0 - sin_t * sin_t, 1e-12))
    r_parl = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-12)
    r_perp = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-12)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return jnp.where(tir, 1.0, fr)


def _fr_conductor_c(c, eta, k):
    """fr_conductor per channel (fresnel.py:32-51, eta_i = 1)."""
    cc = jnp.clip(c, -1.0, 1.0)
    c2 = cc * cc
    s2 = 1.0 - c2
    eta2 = eta * eta
    etak2 = k * k
    t0 = eta2 - etak2 - s2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * eta2 * etak2, 1e-12))
    t1 = a2b2 + c2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 1e-12))
    t2 = 2.0 * cc * a
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


def _safe_div(v):
    # vm._safe: replace ~0 with +-1e-12, keeping sign
    return jnp.where(jnp.abs(v) < 1e-12,
                     jnp.where(v < 0.0, -1e-12, 1e-12), v)


def _rect_t(pt_ref, k, ox, oy, oz, wx, wy, wz):
    """Exact rect_ts formula (ops/intersect.py:117-141) for table row k."""
    p0x, p0y, p0z = pt_ref[k, 0], pt_ref[k, 1], pt_ref[k, 2]
    rwx, rwy, rwz = pt_ref[k, 3], pt_ref[k, 4], pt_ref[k, 5]
    rhx, rhy, rhz = pt_ref[k, 6], pt_ref[k, 7], pt_ref[k, 8]
    rnx, rny, rnz = pt_ref[k, 9], pt_ref[k, 10], pt_ref[k, 11]
    denom = wx * rnx + wy * rny + wz * rnz
    t = ((p0x - ox) * rnx + (p0y - oy) * rny + (p0z - oz) * rnz) \
        / _safe_div(denom)
    qx = ox + t * wx - p0x
    qy = oy + t * wy - p0y
    qz = oz + t * wz - p0z
    uu = (qx * rwx + qy * rwy + qz * rwz) \
        / (rwx * rwx + rwy * rwy + rwz * rwz)
    vv = (qx * rhx + qy * rhy + qz * rhz) \
        / (rhx * rhx + rhy * rhy + rhz * rhz)
    ok = ((t > K_EPSILON) & (uu >= 0.0) & (uu <= 1.0)
          & (vv >= 0.0) & (vv <= 1.0))
    return jnp.where(ok, t, TMAX)


def _plane_t(pt_ref, k, ox, oy, oz, wx, wy, wz):
    """Exact plane_ts formula (ops/intersect.py:102-114) for table row k:
    unbounded single-sided-normal plane, no facing flip."""
    p0x, p0y, p0z = pt_ref[k, 0], pt_ref[k, 1], pt_ref[k, 2]
    pnx, pny, pnz = pt_ref[k, 9], pt_ref[k, 10], pt_ref[k, 11]
    denom = wx * pnx + wy * pny + wz * pnz
    t = ((p0x - ox) * pnx + (p0y - oy) * pny + (p0z - oz) * pnz) \
        / _safe_div(denom)
    return jnp.where(t > K_EPSILON, t, TMAX)


def _disk_t(pt_ref, k, ox, oy, oz, wx, wy, wz):
    """Exact disk_ts formula (ops/intersect.py:143-160) for table row k:
    plane hit + radius^2 containment (radius lives in col 6)."""
    cx, cy, cz = pt_ref[k, 0], pt_ref[k, 1], pt_ref[k, 2]
    r = pt_ref[k, 6]
    dnx, dny, dnz = pt_ref[k, 9], pt_ref[k, 10], pt_ref[k, 11]
    denom = wx * dnx + wy * dny + wz * dnz
    t = ((cx - ox) * dnx + (cy - oy) * dny + (cz - oz) * dnz) \
        / _safe_div(denom)
    qx = ox + t * wx - cx
    qy = oy + t * wy - cy
    qz = oz + t * wz - cz
    ok = (t > K_EPSILON) & ((qx * qx + qy * qy + qz * qz) <= r * r)
    return jnp.where(ok, t, TMAX)


def _tri_t(pt_ref, k, ox, oy, oz, wx, wy, wz):
    """Exact triangle_ts Moller-Trumbore (ops/intersect.py:163-197)."""
    v0x, v0y, v0z = pt_ref[k, 0], pt_ref[k, 1], pt_ref[k, 2]
    e1x, e1y, e1z = pt_ref[k, 3], pt_ref[k, 4], pt_ref[k, 5]
    e2x, e2y, e2z = pt_ref[k, 6], pt_ref[k, 7], pt_ref[k, 8]
    cpx = wy * e2z - wz * e2y
    cpy = wz * e2x - wx * e2z
    cpz = wx * e2y - wy * e2x
    det = e1x * cpx + e1y * cpy + e1z * cpz
    inv_det = 1.0 / _safe_div(det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    beta = (tx * cpx + ty * cpy + tz * cpz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    gamma = (wx * qx + wy * qy + wz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
          & (t > K_EPSILON))
    return jnp.where(ok, t, TMAX)


def _sphere_t(pt_ref, k, ox, oy, oz, wx, wy, wz):
    """Exact sphere_ts (ops/intersect.py:61-100): stable quadratic
    (core/solvers.py solve_quadratic) + the phi/theta clip window,
    including the unclamped-acos rejection quirk (|cos| > 1 misses).

    The window is tested in COSINE space (no atan2/acos per lane) —
    algebraically identical on the reals (|atan2(x,z)| <= p equals
    z/sqrt(x^2+z^2) >= cos p, and theta-in-[mn,mx] equals cos_raw in
    [cos mx, cos mn] since cos is decreasing on [0,pi]); boundary lanes
    can differ by an f32 ulp (measure zero under MC)."""
    cx, cy, cz = pt_ref[k, 0], pt_ref[k, 1], pt_ref[k, 2]
    r = pt_ref[k, 3]
    # cols 4-6: cos(phi), cos(min_theta), cos(max_theta) (host-computed)
    cphi_s, cmn, cmx = pt_ref[k, 4], pt_ref[k, 5], pt_ref[k, 6]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = wx * wx + wy * wy + wz * wz
    b = 2.0 * (ocx * wx + ocy * wy + ocz * wz)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
    disc = b * b - 4.0 * a * c
    ok_d = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.where(b >= 0.0, sq, -sq))
    safe_a = jnp.where(a == 0.0, 1.0, a)
    safe_q = jnp.where(q == 0.0, 1.0, q)
    r0 = q / safe_a
    r1 = c / safe_q
    lin = a == 0.0
    bl = jnp.where(b == 0.0, 1.0, b)
    r_lin = -c / bl
    r0 = jnp.where(lin, r_lin, r0)
    r1 = jnp.where(lin, r_lin, r1)
    t0 = jnp.where(ok_d, jnp.minimum(r0, r1), TMAX)
    t1 = jnp.where(ok_d, jnp.maximum(r0, r1), TMAX)

    def accept(t):
        hx = ox + t * wx - cx
        hy = oy + t * wy - cy
        hz = oz + t * wz - cz
        # |atan2(hx, hz)| <= phi  <=>  hz/|xz| >= cos(phi); atan2(0,0)=0
        # always passes, matched by the max() guard making the ratio 0
        xz = jnp.sqrt(jnp.maximum(hx * hx + hz * hz, 1e-30))
        cos_raw = hy / r
        ok = ((t > K_EPSILON) & (t < TMAX) & (hz / xz >= cphi_s)
              & (cos_raw <= cmn) & (cos_raw >= cmx)
              & (jnp.abs(cos_raw) <= 1.0))
        return jnp.where(ok, t, TMAX)

    return jnp.minimum(accept(t0), accept(t1))


def _box_object_ray(bt_ref, k, ox, oy, oz, wx, wy, wz):
    """World ray -> instance object space via the stored [3,4] affine
    (cols 0-11 row-major; _instanced_object_rays, ops/intersect.py:198-206).
    Direction is NOT renormalized so t parametrizes the world ray."""
    oox = bt_ref[k, 0] * ox + bt_ref[k, 1] * oy + bt_ref[k, 2] * oz \
        + bt_ref[k, 3]
    ooy = bt_ref[k, 4] * ox + bt_ref[k, 5] * oy + bt_ref[k, 6] * oz \
        + bt_ref[k, 7]
    ooz = bt_ref[k, 8] * ox + bt_ref[k, 9] * oy + bt_ref[k, 10] * oz \
        + bt_ref[k, 11]
    odx = bt_ref[k, 0] * wx + bt_ref[k, 1] * wy + bt_ref[k, 2] * wz
    ody = bt_ref[k, 4] * wx + bt_ref[k, 5] * wy + bt_ref[k, 6] * wz
    odz = bt_ref[k, 8] * wx + bt_ref[k, 9] * wy + bt_ref[k, 10] * wz
    return oox, ooy, ooz, odx, ody, odz


def _box_t(bt_ref, k, ox, oy, oz, wx, wy, wz):
    """Exact instanced-AABOX distance (_aabox_ts slab test on the
    canonical centered box, ops/intersect.py:209-220) for box-table
    row k (half extents in cols 21-23)."""
    oox, ooy, ooz, odx, ody, odz = _box_object_ray(
        bt_ref, k, ox, oy, oz, wx, wy, wz)
    hx, hy, hz = bt_ref[k, 21], bt_ref[k, 22], bt_ref[k, 23]
    ivx = 1.0 / _safe_div(odx)
    ivy = 1.0 / _safe_div(ody)
    ivz = 1.0 / _safe_div(odz)
    t0x = (-hx - oox) * ivx
    t1x = (hx - oox) * ivx
    t0y = (-hy - ooy) * ivy
    t1y = (hy - ooy) * ivy
    t0z = (-hz - ooz) * ivz
    t1z = (hz - ooz) * ivz
    tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                 jnp.minimum(t0y, t1y)),
                     jnp.minimum(t0z, t1z))
    tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                 jnp.maximum(t0y, t1y)),
                     jnp.maximum(t0z, t1z))
    ok = (tn < tf) & (tf > K_EPSILON)
    t = jnp.where(tn > K_EPSILON, tn, tf)
    return jnp.where(ok, t, TMAX)


# Per-type row kernels in intersect_scene's GROUP ORDER (_GROUPS,
# ops/intersect.py:504-510): sphere, plane, rect, disk, triangle, then
# the instanced AABOX table. The tables are packed in this order so the
# fori's strict < keeps the XLA path's first-minimum tie-break across
# groups.
_BRUTE_ORDER = (_sphere_t, _plane_t, _rect_t, _disk_t, _tri_t)


def _group_spans(counts):
    off = 0
    for n, fn in zip(counts, _BRUTE_ORDER):
        yield off, off + n, fn
        off += n


def _brute_closest(pt_ref, counts, ox, oy, oz, wx, wy, wz,
                   bt_ref=None, n_box=0):
    """Closest hit over the primitive table as fori_loops per type
    (counts = (n_sph, n_pl, n_rects, n_dsk, n_tris) in intersect_scene's
    group order; instanced AABOX rows in bt_ref index after the last
    group); loops keep the kernel body small where full unrolling would
    multiply it by the primitive count. Strict < keeps min/argmin's
    first-minimum tie-break."""
    best_t = jnp.full_like(ox, TMAX)
    best_k = jnp.zeros_like(ox, dtype=jnp.int32)

    def mk(body_t):
        def body(k, carry):
            bt, bk = carry
            t = body_t(pt_ref, k, ox, oy, oz, wx, wy, wz)
            better = t < bt
            return jnp.where(better, t, bt), jnp.where(better, k, bk)

        return body

    carry = (best_t, best_k)
    for lo, hi, fn in _group_spans(counts):
        if hi > lo:
            carry = jax.lax.fori_loop(lo, hi, mk(fn), carry)
    if n_box:
        n_tot = sum(counts)

        def box_body(k, carry):
            bt, bk = carry
            t = _box_t(bt_ref, k, ox, oy, oz, wx, wy, wz)
            better = t < bt
            return (jnp.where(better, t, bt),
                    jnp.where(better, n_tot + k, bk))

        carry = jax.lax.fori_loop(0, n_box, box_body, carry)
    return carry


def _brute_any(pt_ref, counts, ox, oy, oz, wx, wy, wz,
               bt_ref=None, n_box=0):
    """shadow_distance brute path: min t over every prim, no early out."""
    t_sh = jnp.full_like(ox, TMAX)

    def mk(body_t):
        def body(k, bt):
            return jnp.minimum(bt, body_t(pt_ref, k, ox, oy, oz,
                                          wx, wy, wz))

        return body

    for lo, hi, fn in _group_spans(counts):
        if hi > lo:
            t_sh = jax.lax.fori_loop(lo, hi, mk(fn), t_sh)
    if n_box:
        def box_body(k, bt):
            return jnp.minimum(bt, _box_t(bt_ref, k, ox, oy, oz,
                                          wx, wy, wz))

        t_sh = jax.lax.fori_loop(0, n_box, box_body, t_sh)
    return t_sh


def _brute_hit(pt_ref, counts, ox_, oy_, oz_, dx, dy, dz,
               bt_ref=None, n_box=0):
    """Closest hit + attribute fill over the primitive table — the
    intersect_scene brute path (spheres, planes, rects, disks, triangles,
    instanced aaboxes in group order; strict < keeps the first-minimum
    tie-break) with the exact _fill_* attribute math. Planes/disks/boxes
    carry a ZERO dpdu so the shade core's Duff fallback reproduces
    vm.orthonormal_basis exactly (_fill_plane/_fill_disk/_fill_instanced,
    ops/intersect.py:347-377,410-501). Returns
    (hitm, px..pz, fn.., dpdu.., mat_id)."""
    n_sph, n_pl, n_rects, n_dsk, n_tris = counts
    n_tot = n_sph + n_pl + n_rects + n_dsk + n_tris
    best_t, best_k = _brute_closest(pt_ref, counts,
                                    ox_, oy_, oz_, dx, dy, dz,
                                    bt_ref=bt_ref, n_box=n_box)
    hitm = best_t < TMAX

    # ---- fill: select the winner's row constants (A = cols 0-2,
    # B = cols 3-5, N = cols 9-11), then per-type attribute math
    zero = jnp.zeros_like(ox_)

    def fill_body(k, carry):
        ax, ay, az, bx2, by2, bz2, nxx, nyy, nzz, mat_f, ds_f = carry
        sel = hitm & (best_k == k)
        # Accumulated as f32 (material ids are small ints, exact in
        # f32) — one vector convert at the end.
        return (jnp.where(sel, pt_ref[k, 0], ax),
                jnp.where(sel, pt_ref[k, 1], ay),
                jnp.where(sel, pt_ref[k, 2], az),
                jnp.where(sel, pt_ref[k, 3], bx2),
                jnp.where(sel, pt_ref[k, 4], by2),
                jnp.where(sel, pt_ref[k, 5], bz2),
                jnp.where(sel, pt_ref[k, 9], nxx),
                jnp.where(sel, pt_ref[k, 10], nyy),
                jnp.where(sel, pt_ref[k, 11], nzz),
                jnp.where(sel, pt_ref[k, 12], mat_f),
                jnp.where(sel, pt_ref[k, 13], ds_f))

    (ax, ay, az, bx2, by2, bz2, fnx, fny, fnz, mat_f, ds_f) = \
        jax.lax.fori_loop(0, n_tot, fill_body, (zero,) * 11)
    mat_id = mat_f.astype(jnp.int32)
    ds_flag = ds_f != 0.0
    is_sph_hit = best_k < n_sph
    is_rect_hit = ((best_k >= n_sph + n_pl)
                   & (best_k < n_sph + n_pl + n_rects))
    is_dsk_hit = ((best_k >= n_sph + n_pl + n_rects)
                  & (best_k < n_sph + n_pl + n_rects + n_dsk))
    is_tri_hit = best_k >= n_sph + n_pl + n_rects + n_dsk
    # rects always face the ray (_fill_rect flip, rect.cpp:36-46), and
    # flip dpdu with the normal; disks face the ray but keep dpdu
    # (_fill_disk); planes NEVER flip (_fill_plane); flat triangles flip
    # only when double-sided (_fill_triangle, triangle.cpp:160-166) and
    # keep dpdu; spheres never flip (_fill_sphere)
    flip = (-dx * fnx - dy * fny - dz * fnz) < 0.0
    do_flip = flip & (is_rect_hit | is_dsk_hit | (is_tri_hit & ds_flag))
    sgn = jnp.where(do_flip, -1.0, 1.0)
    fnx = fnx * sgn
    fny = fny * sgn
    fnz = fnz * sgn
    du_sgn = jnp.where(do_flip & is_rect_hit, -1.0, 1.0)
    ndx, ndy, ndz, _ = _normalize3(bx2 * du_sgn, by2 * du_sgn,
                                   bz2 * du_sgn)
    t_out = best_t
    if n_sph:
        # sphere attribute fill (_fill_sphere): one detached-Newton step
        # on F(t) = |o + t d - c|^2 - r^2 (the differentiable-fill value
        # the XLA path produces), normal from the refined point, dpdu ~
        # (-(z-cz), 0, (x-cx)) (fillShadeRecSphere, sphere.cpp:4-31)
        r_s = bx2  # col 3 holds the radius for sphere rows
        socx = ox_ + best_t * dx - ax
        socy = oy_ + best_t * dy - ay
        socz = oz_ + best_t * dz - az
        F = socx * socx + socy * socy + socz * socz - r_s * r_s
        Fp = 2.0 * (socx * dx + socy * dy + socz * dz)
        t_n = best_t - F / _safe_div(Fp)
        relx = ox_ + t_n * dx - ax
        rely = oy_ + t_n * dy - ay
        relz = oz_ + t_n * dz - az
        snx_s, sny_s, snz_s, _ = _normalize3(relx, rely, relz)
        sdx, sdy, sdz, _ = _normalize3(-relz, jnp.zeros_like(relz), relx)
        t_out = jnp.where(is_sph_hit, t_n, t_out)
        fnx = jnp.where(is_sph_hit, snx_s, fnx)
        fny = jnp.where(is_sph_hit, sny_s, fny)
        fnz = jnp.where(is_sph_hit, snz_s, fnz)
        ndx = jnp.where(is_sph_hit, sdx, ndx)
        ndy = jnp.where(is_sph_hit, sdy, ndy)
        ndz = jnp.where(is_sph_hit, sdz, ndz)
    if n_box:
        # instanced AABOX fill (_fill_instanced box legs,
        # ops/intersect.py:410-501): select the winning box row's affine
        # + normal matrix + half extents, redo the object-space ray, one
        # face-plane Newton step (value-preserving like the XLA t_diff),
        # dominant-axis normal from the refined point, world push through
        # (M^-1)^T, then face toward the ray. dpdu stays zero (Duff
        # fallback = orthonormal_basis of the faced normal).
        is_box_hit = hitm & (best_k >= n_tot)
        acc = (zero,) * 25

        def box_fill(k, carry):
            sel = is_box_hit & (best_k == n_tot + k)
            return tuple(jnp.where(sel, bt_ref[k, c], v)
                         for c, v in zip((0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                          10, 11, 12, 13, 14, 15, 16, 17,
                                          18, 19, 20, 21, 22, 23, 24),
                                         carry))

        (a00, a01, a02, b0, a10, a11, a12, b1, a20, a21, a22, b2,
         m00, m01, m02, m10, m11, m12, m20, m21, m22,
         hx_b, hy_b, hz_b, bmat) = \
            jax.lax.fori_loop(0, n_box, box_fill, acc)
        oox = a00 * ox_ + a01 * oy_ + a02 * oz_ + b0
        ooy = a10 * ox_ + a11 * oy_ + a12 * oz_ + b1
        ooz = a20 * ox_ + a21 * oy_ + a22 * oz_ + b2
        odx = a00 * dx + a01 * dy + a02 * dz
        ody = a10 * dx + a11 * dy + a12 * dz
        odz = a20 * dx + a21 * dy + a22 * dz
        hpx = oox + best_t * odx
        hpy = ooy + best_t * ody
        hpz = ooz + best_t * odz

        def dominant(rx, ry, rz):
            arx, ary, arz = jnp.abs(rx), jnp.abs(ry), jnp.abs(rz)
            use_x = (arx >= ary) & (arx >= arz)  # argmax first-tie order
            use_y = (~use_x) & (ary >= arz)
            use_z = (~use_x) & (~use_y)
            return (jnp.where(use_x, jnp.sign(rx), 0.0),
                    jnp.where(use_y, jnp.sign(ry), 0.0),
                    jnp.where(use_z, jnp.sign(rz), 0.0))

        nfx, nfy, nfz = dominant(hpx / _safe_div(hx_b),
                                 hpy / _safe_div(hy_b),
                                 hpz / _safe_div(hz_b))
        F_b = (hpx * nfx + hpy * nfy + hpz * nfz) \
            - (hx_b * jnp.abs(nfx) + hy_b * jnp.abs(nfy)
               + hz_b * jnp.abs(nfz))
        Fp_b = odx * nfx + ody * nfy + odz * nfz
        t_nb = best_t - F_b / _safe_div(Fp_b)
        h2x = oox + t_nb * odx
        h2y = ooy + t_nb * ody
        h2z = ooz + t_nb * odz
        n2x, n2y, n2z = dominant(h2x / _safe_div(hx_b),
                                 h2y / _safe_div(hy_b),
                                 h2z / _safe_div(hz_b))
        wnx = m00 * n2x + m01 * n2y + m02 * n2z
        wny = m10 * n2x + m11 * n2y + m12 * n2z
        wnz = m20 * n2x + m21 * n2y + m22 * n2z
        wnx, wny, wnz, _ = _normalize3(wnx, wny, wnz)
        bflip = (wnx * dx + wny * dy + wnz * dz) > 0.0
        bsgn = jnp.where(bflip, -1.0, 1.0)
        t_out = jnp.where(is_box_hit, t_nb, t_out)
        fnx = jnp.where(is_box_hit, wnx * bsgn, fnx)
        fny = jnp.where(is_box_hit, wny * bsgn, fny)
        fnz = jnp.where(is_box_hit, wnz * bsgn, fnz)
        ndx = jnp.where(is_box_hit, 0.0, ndx)
        ndy = jnp.where(is_box_hit, 0.0, ndy)
        ndz = jnp.where(is_box_hit, 0.0, ndz)
        mat_id = jnp.where(is_box_hit, bmat.astype(jnp.int32), mat_id)
    px = jnp.where(hitm, ox_ + t_out * dx, 0.0)
    py = jnp.where(hitm, oy_ + t_out * dy, 0.0)
    pz = jnp.where(hitm, oz_ + t_out * dz, 0.0)
    return hitm, px, py, pz, fnx, fny, fnz, ndx, ndy, ndz, mat_id


def _camera_raygen(cam_ref, pix, spp, seed, width, raygen,
                   thinlens=False):
    """In-kernel raygen: film jitter (plain CAMERA_BOUNCE uniforms
    or the production stratified_jitter, sampling/multijitter.py:46-59)
    + generate_rays' pinhole math (camera.py:118-144), or with
    `thinlens` the calcRayThinLens port (camera.py:146-169: polar-warp
    lens disk from CAMERA_BOUNCE dims 2,3; direction normalized in
    CAMERA space before the world transform, matching the XLA order).
    cam_ref (f32): 0-2 position, 3-5 x_axis, 6-8 y_axis,
    9-11 z_axis, 12 focal_dist, 13 frame_length, 14 frame_height,
    15 pixel_length, 16 focal_length, 17 lens_radius."""
    f32 = jnp.float32
    # col/row without integer div: the f32 reciprocal row estimate can be
    # off by one at row boundaries (1/width is inexact), so correct it
    # exactly from the residual — valid while pix_f itself is exact
    # (film.num_pixels <= 2^24, gated by the callers).
    pix_f = pix.astype(jnp.int32).astype(f32)
    inv_w = f32(1.0 / width)
    rowf = jnp.floor((pix_f + 0.5) * inv_w)
    colf = pix_f - rowf * f32(width)
    over = colf < 0.0
    rowf = jnp.where(over, rowf - 1.0, rowf)
    colf = jnp.where(over, colf + f32(width), colf)
    under = colf >= f32(width)
    rowf = jnp.where(under, rowf + 1.0, rowf)
    colf = jnp.where(under, colf - f32(width), colf)
    # CAMERA_BOUNCE uniforms, dims 0,1 (sampling/rng.py)
    h = _fmix(pix)
    h = _fmix(h ^ _fmix(spp))
    h = _fmix(h ^ (seed + _GOLDEN * jnp.uint32(0x7FFF)))

    def uni(dim):
        bits = _fmix(h + _GOLDEN * jnp.uint32(dim))
        return (bits >> jnp.uint32(8)).astype(f32) * f32(1.0 / (1 << 24))

    u0, u1 = uni(0), uni(1)
    if raygen == "strat":
        # stratified_jitter: per-pixel rotated 4x4 stratum + in-stratum u
        rot = _fmix(pix ^ (seed * jnp.uint32(977))) % jnp.uint32(16)
        stratum = (spp + rot) % jnp.uint32(16)
        st_i = stratum.astype(jnp.int32).astype(f32)
        sy = jnp.floor((st_i + 0.5) * f32(0.25))
        sx = st_i - sy * 4.0
        j0 = (sx + u0) * 0.25
        j1 = (sy + u1) * 0.25
    else:
        j0, j1 = u0, u1
    ix = -cam_ref[13] * 0.5 + cam_ref[15] * (colf + j0)
    iy = cam_ref[14] * 0.5 - cam_ref[15] * (rowf + j1)
    fd = cam_ref[12]
    if thinlens:
        # map_to_disk_polar (sampling/mappings.py:17-21) * lens_radius,
        # lens samples = CAMERA_BOUNCE dims 2,3 (wavefront.py lens_u)
        u2, u3 = uni(2), uni(3)
        phi_l = f32(TWO_PI) * u2
        rl = jnp.sqrt(u3) * cam_ref[17]
        lx = rl * jnp.cos(phi_l)
        ly = rl * jnp.sin(phi_l)
        fl = cam_ref[16]
        scale = fl / fd
        # d_cam = normalize(fp - o_cam) in CAMERA space, then the world
        # transform with NO re-normalize (generate_rays thin-lens order)
        ncx, ncy, ncz, _ = _normalize3(ix * scale - lx, iy * scale - ly,
                                       -fl - fd)
        ndx = ncx * cam_ref[3] + ncy * cam_ref[6] + ncz * cam_ref[9]
        ndy = ncx * cam_ref[4] + ncy * cam_ref[7] + ncz * cam_ref[10]
        ndz = ncx * cam_ref[5] + ncy * cam_ref[8] + ncz * cam_ref[11]
        ox = lx * cam_ref[3] + ly * cam_ref[6] + fd * cam_ref[9] \
            + cam_ref[0]
        oy = lx * cam_ref[4] + ly * cam_ref[7] + fd * cam_ref[10] \
            + cam_ref[1]
        oz = lx * cam_ref[5] + ly * cam_ref[8] + fd * cam_ref[11] \
            + cam_ref[2]
        return ox, oy, oz, ndx, ndy, ndz
    dxr = ix * cam_ref[3] + iy * cam_ref[6] - fd * cam_ref[9]
    dyr = ix * cam_ref[4] + iy * cam_ref[7] - fd * cam_ref[10]
    dzr = ix * cam_ref[5] + iy * cam_ref[8] - fd * cam_ref[11]
    ndx, ndy, ndz, _ = _normalize3(dxr, dyr, dzr)
    ox = ix * cam_ref[3] + iy * cam_ref[6] + cam_ref[0]
    oy = ix * cam_ref[4] + iy * cam_ref[7] + cam_ref[1]
    oz = ix * cam_ref[5] + iy * cam_ref[8] + cam_ref[2]
    return ox, oy, oz, ndx, ndy, ndz


def _pass_kernel(seed_ref, sf_ref, mt_ref, lt_ref, pt_ref, bt_ref,
                 ray_ref, pix_ref, spp_ref, lo_ref, go_ref,
                 n_mats, n_lights, prim_counts, n_box, max_depth,
                 rr_start, has_mirror=False, has_sphere_light=False,
                 has_oren=False, has_plastic=False, has_metal=False,
                 has_glass=False, has_transparent=False,
                 raygen=None, width=0, thinlens=False):
    """One program = one lane block; the ENTIRE bounce loop runs inside
    it with the per-lane path state (ray, beta, L, liveness) carried in
    registers. Per bounce: closest hit over the primitive table, shade,
    shadow any-hit, throughput/RR.

    Inputs: the tables (seed, env radiance, materials, lights, prims,
    boxes) are whole arrays read by scalar index; `ray_ref` is either the
    lane block's rays (rows 0-2 origin, 3-5 direction) or, with `raygen`
    ("plain" | "strat"), the camera array of _camera_raygen — the pass then
    consumes only pixel ids.

    Outputs: lo_ref rows 0-2 = L; go_ref rows = [good, rays (live-lane
    count summed over bounces), shadow_rays, alive-per-bounce bitmask
    (bit b = lane alive entering bounce b — popcounted outside into the
    reference's live histogram)]."""
    pix = pix_ref[...].astype(jnp.uint32)
    spp = spp_ref[...].astype(jnp.uint32)
    seed = seed_ref[0].astype(jnp.uint32)
    if raygen is not None:
        ox0, oy0, oz0, dx0, dy0, dz0 = _camera_raygen(
            ray_ref, pix, spp, seed, width, raygen, thinlens=thinlens)
    else:
        ox0, oy0, oz0 = ray_ref[0, :], ray_ref[1, :], ray_ref[2, :]
        dx0, dy0, dz0 = ray_ref[3, :], ray_ref[4, :], ray_ref[5, :]
    zero = jnp.zeros_like(ox0)
    one = jnp.ones_like(ox0)
    izero = jnp.zeros_like(ox0, dtype=jnp.int32)

    def occl(sx, sy, sz, wx, wy, wz):
        return _brute_any(pt_ref, prim_counts, sx, sy, sz, wx, wy, wz,
                          bt_ref=bt_ref, n_box=n_box)

    def bounce_body(b, carry):
        # liveness legs ride as i32 0/1: they feed the i32 counters below
        (ox, oy, oz, dx, dy, dz, bx, by, bz, lr, lg, lb,
         good, alive_i, psg_i, rays_c, shad_c, hist) = carry
        alive = alive_i != 0
        prev_sg = psg_i != 0
        (hitm, px, py, pz, fnx, fny, fnz, ndx, ndy, ndz,
         mat_id) = _brute_hit(pt_ref, prim_counts,
                              ox, oy, oz, dx, dy, dz,
                              bt_ref=bt_ref, n_box=n_box)
        out = _shade_core(seed, b, sf_ref, mt_ref, lt_ref,
                          dx, dy, dz, px, py, pz, fnx, fny, fnz,
                          ndx, ndy, ndz, bx, by, bz, pix, spp, mat_id,
                          hitm, alive, prev_sg,
                          n_mats, n_lights, max_depth, rr_start,
                          occl=occl, has_mirror=has_mirror,
                          has_sphere_light=has_sphere_light,
                          has_oren=has_oren, has_plastic=has_plastic,
                          has_metal=has_metal, has_glass=has_glass,
                          has_transparent=has_transparent)
        return (out["new_o"][0], out["new_o"][1], out["new_o"][2],
                out["new_d"][0], out["new_d"][1], out["new_d"][2],
                out["new_beta"][0], out["new_beta"][1],
                out["new_beta"][2],
                lr + out["l_add"][0], lg + out["l_add"][1],
                lb + out["l_add"][2],
                good + out["good_inc"],
                out["new_alive"].astype(jnp.int32),
                out["new_prev_sg"].astype(jnp.int32),
                rays_c + alive_i,
                shad_c + out["want_shadow"].astype(jnp.int32),
                hist | (alive_i << b))

    init = (ox0, oy0, oz0, dx0, dy0, dz0, one, one, one,
            zero, zero, zero, izero, izero + 1, izero, izero, izero,
            izero)
    final = jax.lax.fori_loop(0, max_depth + 1, bounce_body, init)
    lo_ref[0, :] = final[9]
    lo_ref[1, :] = final[10]
    lo_ref[2, :] = final[11]
    go_ref[0, :] = final[12]
    go_ref[1, :] = final[15]
    go_ref[2, :] = final[16]
    go_ref[3, :] = final[17]


def _shade_core(seed, bounce, sf_ref, mt_ref, lt_ref,
                dx, dy, dz, px, py, pz, nx, ny, nz, ux, uy, uz,
                bx, by, bz, pix, spp, mat_id, hitm, alive, prev_sg,
                n_mats, n_lights, max_depth, rr_start, occl,
                has_mirror=False, has_sphere_light=False,
                has_oren=False, has_plastic=False, has_metal=False,
                has_glass=False, has_transparent=False):
    """Pure shade math (no ref writes): returns the per-lane output dict.
    `seed` is a u32 scalar, `bounce` an i32 scalar (possibly a loop
    carry — the pass kernel iterates this body over bounces)."""
    f32 = jnp.float32
    bounce_u = bounce.astype(jnp.uint32)

    # ---- material row select (gather_params over a tiny static table)
    zero = jnp.zeros_like(px)
    mtype = jnp.zeros_like(mat_id)
    cr = zero
    cg = zero
    cb = zero
    on_a = zero
    inten = zero
    on_b = zero
    ax_m = zero
    ksr = zero
    ksg = zero
    ksb = zero
    etr = zero
    etg = zero
    etb = zero
    kkr = zero
    kkg = zero
    kkb = zero
    ior_i = zero
    ior_o = zero
    for m in range(n_mats):
        sel = mat_id == m
        mtype = jnp.where(sel, jnp.int32(1) * mt_ref[m, 0].astype(jnp.int32),
                          mtype)
        cr = jnp.where(sel, mt_ref[m, 1], cr)
        cg = jnp.where(sel, mt_ref[m, 2], cg)
        cb = jnp.where(sel, mt_ref[m, 3], cb)
        on_a = jnp.where(sel, mt_ref[m, 4], on_a)
        inten = jnp.where(sel, mt_ref[m, 5], inten)
        if has_oren:
            on_b = jnp.where(sel, mt_ref[m, 6], on_b)
        if has_plastic or has_metal or has_glass:
            ax_m = jnp.where(sel, mt_ref[m, 7], ax_m)
        if has_plastic:
            ksr = jnp.where(sel, mt_ref[m, 8], ksr)
            ksg = jnp.where(sel, mt_ref[m, 9], ksg)
            ksb = jnp.where(sel, mt_ref[m, 10], ksb)
        if has_metal:
            etr = jnp.where(sel, mt_ref[m, 11], etr)
            etg = jnp.where(sel, mt_ref[m, 12], etg)
            etb = jnp.where(sel, mt_ref[m, 13], etb)
            kkr = jnp.where(sel, mt_ref[m, 14], kkr)
            kkg = jnp.where(sel, mt_ref[m, 15], kkg)
            kkb = jnp.where(sel, mt_ref[m, 16], kkb)
        if has_glass or has_transparent:
            ior_i = jnp.where(sel, mt_ref[m, 17], ior_i)
            ior_o = jnp.where(sel, mt_ref[m, 18], ior_o)

    # ---- emitted / env add (trace.h:419-455; env radiance is a constant
    # for kind<=1 scenes — sf_ref carries color*intensity)
    emissive_hit = hitm & (mtype == T.MAT_EMISSIVE)
    add_cond = alive & ((bounce == 0) | prev_sg)
    add_emit = add_cond & emissive_hit
    add_env = add_cond & ~hitm
    er, eg, eb = cr * inten, cg * inten, cb * inten
    l_add_r = jnp.where(add_emit, bx * er, 0.0) + jnp.where(
        add_env, bx * sf_ref[0], 0.0)
    l_add_g = jnp.where(add_emit, by * eg, 0.0) + jnp.where(
        add_env, by * sf_ref[1], 0.0)
    l_add_b = jnp.where(add_emit, bz * eb, 0.0) + jnp.where(
        add_env, bz * sf_ref[2], 0.0)
    good_inc = (add_emit | add_env).astype(jnp.int32)

    cont = alive & hitm & ~emissive_hit & (bounce < max_depth)

    # ---- shading frame (make_shading_frame on sanitized inputs)
    snx = jnp.where(hitm, nx, 0.0)
    sny = jnp.where(hitm, ny, 0.0)
    snz = jnp.where(hitm, nz, 1.0)
    sux = jnp.where(hitm, ux, 1.0)
    suy = jnp.where(hitm, uy, 0.0)
    suz = jnp.where(hitm, uz, 0.0)
    ndu = snx * sux + sny * suy + snz * suz
    tx = sux - ndu * snx
    ty = suy - ndu * sny
    tz = suz - ndu * snz
    t_len2 = tx * tx + ty * ty + tz * tz
    # Duff orthonormal basis fallback (vm.orthonormal_basis)
    s = jnp.where(snz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + snz)
    bfac = snx * sny * a
    ftx_f = 1.0 + s * snx * snx * a
    fty_f = s * bfac
    ftz_f = -s * snx
    ntx, nty, ntz, _ = _normalize3(tx, ty, tz)
    use_t = t_len2 > 1e-12
    ftx = jnp.where(use_t, ntx, ftx_f)
    fty = jnp.where(use_t, nty, fty_f)
    ftz = jnp.where(use_t, ntz, ftz_f)
    # b = normalize(cross(n, t))
    cbx = sny * ftz - snz * fty
    cby = snz * ftx - snx * ftz
    cbz = snx * fty - sny * ftx
    fbx, fby, fbz, _ = _normalize3(cbx, cby, cbz)
    fnx, fny, fnz = snx, sny, snz

    # ---- counter RNG (sampling/rng.py uniforms, dims 0,1,4,5,6,8; the
    # layout's dims 2,3 are consumed-but-unused scatter samples and dim 7
    # is the fresnel-branch rand — no matte consumer, XLA fuses them away)
    h = _fmix(pix)
    h = _fmix(h ^ _fmix(spp))
    h = _fmix(h ^ (seed + _GOLDEN * bounce_u))

    def uni(dim):
        bits = _fmix(h + _GOLDEN * jnp.uint32(dim))
        return (bits >> jnp.uint32(8)).astype(f32) * f32(1.0 / (1 << 24))

    u_l0, u_l1 = uni(0), uni(1)
    u_pick = uni(4)
    u_b0, u_b1 = uni(5), uni(6)
    if has_glass or has_transparent:
        r_extra = uni(7)  # fresnel-branch rand (trace.h layout dim 7)
    u_rr = uni(8)

    # ---- NEE: power-CDF pick + rect-area sample (trace.h:221-397).
    # The table is tiny and static: unrolled compare/select reproduces
    # searchsorted(side='right') + clip + take_rows exactly. Zero-power
    # rows (e.g. a black env light) keep zero-width CDF intervals and die
    # on the pick_p > 0 test, exactly as in lights.py sample_one_light.
    idx = jnp.zeros_like(mat_id)
    for k in range(n_lights):
        idx = idx + (u_pick >= lt_ref[k, 16]).astype(jnp.int32)
    idx = jnp.minimum(idx, n_lights - 1)
    p0x = zero
    p0y = zero
    p0z = zero
    v1x = zero
    v1y = zero
    v1z = zero
    v2x = zero
    v2y = zero
    v2z = zero
    lnx = zero
    lny = zero
    lnz = zero
    lir = zero
    lig = zero
    lib = zero
    pick_p = zero
    for k in range(n_lights):
        sel = idx == k
        p0x = jnp.where(sel, lt_ref[k, 0], p0x)
        p0y = jnp.where(sel, lt_ref[k, 1], p0y)
        p0z = jnp.where(sel, lt_ref[k, 2], p0z)
        v1x = jnp.where(sel, lt_ref[k, 3], v1x)
        v1y = jnp.where(sel, lt_ref[k, 4], v1y)
        v1z = jnp.where(sel, lt_ref[k, 5], v1z)
        v2x = jnp.where(sel, lt_ref[k, 6], v2x)
        v2y = jnp.where(sel, lt_ref[k, 7], v2y)
        v2z = jnp.where(sel, lt_ref[k, 8], v2z)
        lnx = jnp.where(sel, lt_ref[k, 9], lnx)
        lny = jnp.where(sel, lt_ref[k, 10], lny)
        lnz = jnp.where(sel, lt_ref[k, 11], lnz)
        lir = jnp.where(sel, lt_ref[k, 12], lir)
        lig = jnp.where(sel, lt_ref[k, 13], lig)
        lib = jnp.where(sel, lt_ref[k, 14], lib)
        pick_p = jnp.where(sel, lt_ref[k, 17], pick_p)

    # rect point (trace.h:244-254): sp = p0 + u0*v1 + u1*v2
    spx = p0x + u_l0 * v1x + u_l1 * v2x
    spy = p0y + u_l0 * v1y + u_l1 * v2y
    spz = p0z + u_l0 * v1z + u_l1 * v2z
    len_v1 = jnp.sqrt(jnp.maximum(v1x * v1x + v1y * v1y + v1z * v1z, 1e-20))
    len_v2 = jnp.sqrt(jnp.maximum(v2x * v2x + v2y * v2y + v2z * v2z, 1e-20))
    pdf_area = 1.0 / jnp.maximum(len_v1 * len_v2, 1e-12)
    lnx_s, lny_s, lnz_s = lnx, lny, lnz
    if has_sphere_light:
        # ---- SPHERE area light (trace.h:230-243 / lights.py): cosine
        # hemisphere about the center->hit axis; pdf = |h.z|/(2 pi^2 r^2).
        # Row select: col 15 radius, col 18 light type.
        rad = zero
        rtyp = zero
        for k in range(n_lights):
            sel = idx == k
            rad = jnp.where(sel, lt_ref[k, 15], rad)
            rtyp = jnp.where(sel, lt_ref[k, 18], rtyp)
        zx, zy, zz, _ = _normalize3(px - p0x, py - p0y, pz - p0z)
        # Duff basis about the light axis (vm.orthonormal_basis)
        zsg = jnp.where(zz >= 0.0, 1.0, -1.0)
        za = -1.0 / (zsg + zz)
        zb_ = zx * zy * za
        ztx = 1.0 + zsg * zx * zx * za
        zty = zsg * zb_
        ztz = -zsg * zx
        zbx = zb_
        zby = zsg + zy * zy * za
        zbz = -zy
        lphi = TWO_PI * u_l0
        lrad = jnp.sqrt(u_l1)
        hx_ = lrad * jnp.cos(lphi)
        hy_ = lrad * jnp.sin(lphi)
        hz_ = jnp.sqrt(jnp.maximum(1.0 - hx_ * hx_ - hy_ * hy_, 1e-12))
        hwx = hx_ * ztx + hy_ * zbx + hz_ * zx
        hwy = hx_ * zty + hy_ * zby + hz_ * zy
        hwz = hx_ * ztz + hy_ * zbz + hz_ * zz
        pdf_sphl = (1.0 / (2.0 * PI * jnp.maximum(rad * rad, 1e-12))
                    * jnp.abs(hz_) * INV_PI)
        is_sphl = rtyp == f32(T.LIGHT_AREA_SPHERE)
        spx = jnp.where(is_sphl, p0x + hwx * rad, spx)
        spy = jnp.where(is_sphl, p0y + hwy * rad, spy)
        spz = jnp.where(is_sphl, p0z + hwz * rad, spz)
        lnx_s = jnp.where(is_sphl, hwx, lnx)
        lny_s = jnp.where(is_sphl, hwy, lny)
        lnz_s = jnp.where(is_sphl, hwz, lnz)
        pdf_area = jnp.where(is_sphl, pdf_sphl, pdf_area)
    lnx, lny, lnz = lnx_s, lny_s, lnz_s
    tox = spx - px
    toy = spy - py
    toz = spz - pz
    dist2 = tox * tox + toy * toy + toz * toz
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
    wix, wiy, wiz, _ = _normalize3(tox, toy, toz)
    # conv = |to|^2 / max(|dot(sn, -wi)|, 1e-12)
    conv = dist2 / jnp.maximum(
        jnp.abs(lnx * -wix + lny * -wiy + lnz * -wiz), 1e-12)
    pdf_sa = pdf_area * conv
    reject = ((tox * lnx + toy * lny + toz * lnz) > 0.0) | (
        (tox * fnx + toy * fny + toz * fnz) < 0.0)
    valid = ~reject & (pdf_sa > 1e-12) & (pick_p > 0.0)
    pdf_nee = pdf_sa * jnp.maximum(pick_p, 1e-12)

    # NEE eval (bsdf_f_direct): diffuse lobes only — MATTE's Oren-Nayar
    # and PLASTIC's FB-diffuse. Reference quirk: the lobe formulas get
    # the WORLD vectors (BSDF_f computes local frames then ignores them,
    # reflection.cpp:719-735) — constant for Lambertian, trig-visible
    # for sigma != 0 and plastic. Other types get f = 0.
    is_matte = mtype == T.MAT_MATTE
    abs_cos_nee = jnp.abs(fnx * wix + fny * wiy + fnz * wiz)
    if has_oren:
        on_fac = _on_scale(wix, wiy, wiz, -dx, -dy, -dz, on_a, on_b)
    else:
        on_fac = on_a * INV_PI
    f_fac = jnp.where(is_matte, on_fac, 0.0)
    f_r = cr * f_fac
    f_g = cg * f_fac
    f_b = cb * f_fac
    if has_plastic:
        is_pl = mtype == T.MAT_PLASTIC
        fbd = _fb_diffuse_scale(wiz, -dz)
        f_r = jnp.where(is_pl, cr * (1.0 - ksr) * fbd, f_r)
        f_g = jnp.where(is_pl, cg * (1.0 - ksg) * fbd, f_g)
        f_b = jnp.where(is_pl, cb * (1.0 - ksb) * fbd, f_b)
    f_r = f_r * abs_cos_nee
    f_g = f_g * abs_cos_nee
    f_b = f_b * abs_cos_nee
    want_shadow = (cont & valid
                   & ((f_r > 0.0) | (f_g > 0.0) | (f_b > 0.0)))

    # shadow origin offset (_offset_ray on the RAW hit normal)
    mag = jnp.maximum(jnp.maximum(jnp.abs(px), jnp.abs(py)), jnp.abs(pz))
    eps = (mag + 1.0) * 1e-4
    side = jnp.where((wix * nx + wiy * ny + wiz * nz) >= 0.0, 1.0, -1.0)
    shox = px + nx * eps * side
    shoy = py + ny * eps * side
    shoz = pz + nz * eps * side
    dist_adj = dist - ((shox - px) * wix + (shoy - py) * wiy
                       + (shoz - pz) * wiz)
    sho_mx = jnp.where(want_shadow, shox, 3.0e18)
    sho_my = jnp.where(want_shadow, shoy, 3.0e18)
    sho_mz = jnp.where(want_shadow, shoz, 3.0e18)
    inv_pdf = 1.0 / jnp.maximum(pdf_nee, 1e-12)
    # ---- shadow any-hit + visibility-masked NEE add (the wavefront
    # step's lit test, trace.h:478 semantics)
    t_shadow = occl(sho_mx, sho_my, sho_mz, wix, wiy, wiz)
    lit = t_shadow >= dist_adj - jnp.maximum(K_EPSILON, 1e-3 * dist_adj)
    add_nee = want_shadow & lit
    ctr = jnp.where(add_nee, bx * (f_r * lir * inv_pdf), 0.0)
    ctg = jnp.where(add_nee, by * (f_g * lig * inv_pdf), 0.0)
    ctb = jnp.where(add_nee, bz * (f_b * lib * inv_pdf), 0.0)
    l_add_r = l_add_r + ctr
    l_add_g = l_add_g + ctg
    l_add_b = l_add_b + ctb
    good_inc = good_inc + ((ctr != 0.0) | (ctg != 0.0)
                           | (ctb != 0.0)).astype(jnp.int32)

    # ---- BSDF sample (bsdf_sample over dims 5,6: MATTE cosine
    # hemisphere, MIRROR specular reflection, PLASTIC two-lobe
    # FresnelBlend, METAL conductor microfacet)
    need_wo_l = (has_mirror or has_plastic or has_metal or has_oren
                 or has_glass or has_transparent)
    if need_wo_l:
        wo_lx = -(dx * ftx + dy * fty + dz * ftz)
        wo_ly = -(dx * fbx + dy * fby + dz * fbz)
        wo_lz = -(dx * fnx + dy * fny + dz * fnz)
    phi = TWO_PI * u_b0
    r = jnp.sqrt(u_b1)
    wlx = r * jnp.cos(phi)
    wly = r * jnp.sin(phi)
    wlz = jnp.sqrt(jnp.maximum(1.0 - wlx * wlx - wly * wly, 1e-12))
    pdf_s = jnp.where(is_matte, wlz * INV_PI, 0.0)
    if has_oren:
        on_sfac = _on_scale(wlx, wly, wlz, wo_lx, wo_ly, wo_lz,
                            on_a, on_b)
    else:
        on_sfac = on_a * INV_PI
    fs_r = jnp.where(is_matte, cr * on_sfac, 0.0)
    fs_g = jnp.where(is_matte, cg * on_sfac, 0.0)
    fs_b = jnp.where(is_matte, cb * on_sfac, 0.0)
    wlx = jnp.where(is_matte, wlx, 0.0)
    wly = jnp.where(is_matte, wly, 0.0)
    wlz = jnp.where(is_matte, wlz, 1.0)
    is_spec = jnp.zeros_like(cont)
    is_glossy = jnp.zeros_like(cont)
    if has_mirror:
        # MIRROR (SpecularReflection_sample_f, reflection.cpp:240-247):
        # wi = (-wo.x, -wo.y, wo.z) in the shading frame, f = color/|cos|
        is_mir = mtype == T.MAT_MIRROR
        inv_cos = 1.0 / jnp.maximum(jnp.abs(wo_lz), 1e-7)
        wlx = jnp.where(is_mir, -wo_lx, wlx)
        wly = jnp.where(is_mir, -wo_ly, wly)
        wlz = jnp.where(is_mir, wo_lz, wlz)
        fs_r = jnp.where(is_mir, cr * inv_cos, fs_r)
        fs_g = jnp.where(is_mir, cg * inv_cos, fs_g)
        fs_b = jnp.where(is_mir, cb * inv_cos, fs_b)
        pdf_s = jnp.where(is_mir, 1.0, pdf_s)
        is_spec = is_mir
    if has_plastic:
        # PLASTIC (BSDF_sample_f two-lobe, reflection.cpp:760-811):
        # uniform lobe pick with sample remap; CHOSEN-lobe pdf must be
        # nonzero; f and pdf then SUM both lobes (the reference quirk)
        is_pl = mtype == T.MAT_PLASTIC
        pick_spec = u_b0 >= 0.5
        u0r = jnp.clip(jnp.where(pick_spec, 2.0 * (u_b0 - 0.5),
                                 2.0 * u_b0), 0.0, 1.0 - 1e-7)
        # diffuse lobe (FresnelBlendDiffuse_sample_f): cosine hemisphere
        # from the REMAPPED u0, flipped to wo's side
        dphi = TWO_PI * u0r
        drad = jnp.sqrt(u_b1)
        pdx = drad * jnp.cos(dphi)
        pdy = drad * jnp.sin(dphi)
        pdz = jnp.sqrt(jnp.maximum(1.0 - pdx * pdx - pdy * pdy, 1e-12))
        pdz = jnp.where(wo_lz < 0.0, -pdz, pdz)
        # specular lobe (FresnelBlendSpecular_sample_f): Beckmann wh +
        # reflect
        whx, why, whz = _sample_wh_beckmann(wo_lx, wo_ly, wo_lz,
                                            u0r, u_b1, ax_m)
        dwh = wo_lx * whx + wo_ly * why + wo_lz * whz
        psx = 2.0 * dwh * whx - wo_lx
        psy = 2.0 * dwh * why - wo_ly
        psz = 2.0 * dwh * whz - wo_lz
        ps_ok = psz * wo_lz > 0.0
        wpx = jnp.where(pick_spec, psx, pdx)
        wpy = jnp.where(pick_spec, psy, pdy)
        wpz = jnp.where(pick_spec, psz, pdz)
        # pdfs of both lobes at the chosen wi
        same_p = wpz * wo_lz > 0.0
        cos_pdf = jnp.where(same_p, jnp.abs(wpz) * INV_PI, 0.0)
        sx_, sy_, sz_, _ = _normalize3(wpx + wo_lx, wpy + wo_ly,
                                       wpz + wo_lz)
        spec_pdf = jnp.where(
            same_p,
            _d_beckmann(sx_, sy_, sz_, ax_m)
            / jnp.maximum(2.0 * (wo_lx * sx_ + wo_ly * sy_
                                 + wo_lz * sz_), 1e-7), 0.0)
        pdf_chosen = jnp.where(pick_spec,
                               jnp.where(ps_ok, spec_pdf, 0.0), cos_pdf)
        pdf_other = jnp.where(pick_spec, cos_pdf, spec_pdf)
        alive_p = pdf_chosen > 0.0
        # f = FB-diffuse + FB-specular at the chosen wi (local frame)
        fbd_s = _fb_diffuse_scale(wpz, wo_lz)
        cos_wh = wpx * sx_ + wpy * sy_ + wpz * sz_
        degen = ((wpx + wo_lx) ** 2 + (wpy + wo_ly) ** 2
                 + (wpz + wo_lz) ** 2) < 1e-16
        p5w = (1.0 - cos_wh) ** 5
        denom_s = 4.0 * jnp.abs(cos_wh) * jnp.maximum(
            jnp.maximum(jnp.abs(wpz), jnp.abs(wo_lz)), 1e-7)
        d_spec = _d_beckmann(sx_, sy_, sz_, ax_m) \
            / jnp.maximum(denom_s, 1e-12)
        d_spec = jnp.where(degen, 0.0, d_spec)

        def fb_f(kd_c, ks_c):
            fres = ks_c + p5w * (1.0 - ks_c)  # schlick_fresnel
            return kd_c * (1.0 - ks_c) * fbd_s + fres * d_spec

        fpr = jnp.where(alive_p, fb_f(cr, ksr), 0.0)
        fpg = jnp.where(alive_p, fb_f(cg, ksg), 0.0)
        fpb = jnp.where(alive_p, fb_f(cb, ksb), 0.0)
        pdf_pl = jnp.where(alive_p, pdf_chosen + pdf_other, 0.0)
        wlx = jnp.where(is_pl, wpx, wlx)
        wly = jnp.where(is_pl, wpy, wly)
        wlz = jnp.where(is_pl, wpz, wlz)
        fs_r = jnp.where(is_pl, fpr, fs_r)
        fs_g = jnp.where(is_pl, fpg, fs_g)
        fs_b = jnp.where(is_pl, fpb, fs_b)
        pdf_s = jnp.where(is_pl, pdf_pl, pdf_s)
        is_glossy = is_glossy | (is_pl & pick_spec)
    if has_metal:
        # METAL (MicrofacetReflection_sample_f, reflection.cpp:329-344):
        # Beckmann wh from the UNREMAPPED sample, conductor Fresnel,
        # f = D G Fr / (4 |ci| |co|), pdf = D |wh.z| / (4 dot(wo, wh))
        is_met = mtype == T.MAT_METAL
        mhx, mhy, mhz = _sample_wh_beckmann(wo_lx, wo_ly, wo_lz,
                                            u_b0, u_b1, ax_m)
        mdwh = wo_lx * mhx + wo_ly * mhy + wo_lz * mhz
        mwx = 2.0 * mdwh * mhx - wo_lx
        mwy = 2.0 * mdwh * mhy - wo_ly
        mwz = 2.0 * mdwh * mhz - wo_lz
        m_ok = mwz * wo_lz > 0.0
        aci = jnp.abs(mwz)
        aco = jnp.abs(wo_lz)
        shx, shy, shz, _ = _normalize3(mwx + wo_lx, mwy + wo_ly,
                                       mwz + wo_lz)
        m_degen = (((mwx + wo_lx) ** 2 + (mwy + wo_ly) ** 2
                    + (mwz + wo_lz) ** 2) < 1e-16) \
            | (aci < 1e-7) | (aco < 1e-7)
        cwh = mwx * shx + mwy * shy + mwz * shz
        d_m = _d_beckmann(shx, shy, shz, ax_m)
        g_m = 1.0 / (1.0 + _lambda_beckmann(wo_lx, wo_ly, wo_lz, ax_m)
                     + _lambda_beckmann(mwx, mwy, mwz, ax_m))
        scale_m = d_m * g_m / jnp.maximum(4.0 * aci * aco, 1e-12)
        scale_m = jnp.where(m_degen, 0.0, scale_m)
        fmr = _fr_conductor_c(cwh, etr, kkr) * scale_m
        fmg = _fr_conductor_c(cwh, etg, kkg) * scale_m
        fmb = _fr_conductor_c(cwh, etb, kkb) * scale_m
        pdf_m = (_d_beckmann(mhx, mhy, mhz, ax_m) * jnp.abs(mhz)
                 / jnp.maximum(4.0 * mdwh, 1e-7))
        fmr = jnp.where(m_ok, fmr, 0.0)
        fmg = jnp.where(m_ok, fmg, 0.0)
        fmb = jnp.where(m_ok, fmb, 0.0)
        pdf_m = jnp.where(m_ok, pdf_m, 0.0)
        wlx = jnp.where(is_met, mwx, wlx)
        wly = jnp.where(is_met, mwy, wly)
        wlz = jnp.where(is_met, mwz, wlz)
        fs_r = jnp.where(is_met, fmr, fs_r)
        fs_g = jnp.where(is_met, fmg, fs_g)
        fs_b = jnp.where(is_met, fmb, fs_b)
        pdf_s = jnp.where(is_met, pdf_m, pdf_s)
        is_glossy = is_glossy | is_met
    if has_transparent:
        # TRANSPARENT thin (SpecularTransmission_sample_f thin branch,
        # reflection.cpp:250-282): fresnel-branch rand picks mirror
        # reflection vs straight-through transmission
        is_tr = mtype == T.MAT_TRANSPARENT
        kr_thin = _fr_dielectric(jnp.abs(wo_lz), ior_i, ior_o)
        take_refl = r_extra <= kr_thin
        # reflection and thin transmission share x/y = -wo.xy; only z flips
        twx = -wo_lx
        twy = -wo_ly
        twz = jnp.where(take_refl, wo_lz, -wo_lz)
        eta_thin = ior_o / ior_i
        mag_tr = jnp.where(take_refl, kr_thin,
                           (1.0 - kr_thin) * eta_thin * eta_thin) \
            / jnp.maximum(jnp.abs(twz), 1e-7)
        pdf_tr = jnp.where(take_refl, kr_thin, 1.0 - kr_thin)
        wlx = jnp.where(is_tr, twx, wlx)
        wly = jnp.where(is_tr, twy, wly)
        wlz = jnp.where(is_tr, twz, wlz)
        fs_r = jnp.where(is_tr, mag_tr, fs_r)
        fs_g = jnp.where(is_tr, mag_tr, fs_g)
        fs_b = jnp.where(is_tr, mag_tr, fs_b)
        pdf_s = jnp.where(is_tr, pdf_tr, pdf_s)
        is_spec = is_spec | is_tr
    if has_glass:
        # GLASS (MicrofacetFresnel_sample_f, reflection.cpp:390-446):
        # Beckmann wh, fresnel-branch pick between microfacet reflection
        # (with the reference's 1 - Fr(wh, wi) quirk weight) and rough
        # transmission through the half-vector
        is_gl = mtype == T.MAT_GLASS
        ghx, ghy, ghz = _sample_wh_beckmann(wo_lx, wo_ly, wo_lz,
                                            u_b0, u_b1, ax_m)
        gdwh = wo_lx * ghx + wo_ly * ghy + wo_lz * ghz
        kr_g = _fr_dielectric(gdwh, ior_i, ior_o)
        g_refl = r_extra <= kr_g
        # ---- reflection branch (_glass_refl_f + D-pdf)
        grx = 2.0 * gdwh * ghx - wo_lx
        gry = 2.0 * gdwh * ghy - wo_ly
        grz = 2.0 * gdwh * ghz - wo_lz
        gr_ok = grz * wo_lz > 0.0
        rhx, rhy, rhz, _ = _normalize3(grx + wo_lx, gry + wo_ly,
                                       grz + wo_lz)
        r_degen = (((grx + wo_lx) ** 2 + (gry + wo_ly) ** 2
                    + (grz + wo_lz) ** 2) < 1e-16) \
            | (jnp.abs(grz) < 1e-7) | (jnp.abs(wo_lz) < 1e-7)
        kr_quirk = 1.0 - _fr_dielectric(
            rhx * grx + rhy * gry + rhz * grz, ior_i, ior_o)
        scale_gr = (_d_beckmann(rhx, rhy, rhz, ax_m)
                    * (1.0 / (1.0 + _lambda_beckmann(wo_lx, wo_ly, wo_lz,
                                                     ax_m)
                       + _lambda_beckmann(grx, gry, grz, ax_m)))
                    / jnp.maximum(4.0 * jnp.abs(grz) * jnp.abs(wo_lz),
                                  1e-12))
        f_gr = jnp.where(r_degen, 0.0, kr_quirk * scale_gr)
        pdf_gr = (_d_beckmann(ghx, ghy, ghz, ax_m) * jnp.abs(ghz)
                  / jnp.maximum(4.0 * gdwh, 1e-7))
        f_gr = jnp.where(gr_ok, f_gr, 0.0)
        pdf_gr = jnp.where(gr_ok, pdf_gr, 0.0)
        # ---- transmission branch (vm.refract through the faced wh)
        eta_g = jnp.where(wo_lz > 0.0, ior_o / ior_i, ior_i / ior_o)
        fsg = jnp.where(gdwh < 0.0, -1.0, 1.0)
        fhx, fhy, fhz = ghx * fsg, ghy * fsg, ghz * fsg
        cti_r = fhx * wo_lx + fhy * wo_ly + fhz * wo_lz
        s2i = jnp.maximum(0.0, 1.0 - cti_r * cti_r)
        s2t = eta_g * eta_g * s2i
        gt_ok = s2t < 1.0
        ctt = jnp.sqrt(jnp.maximum(1.0 - s2t, 1e-12))
        gtx = -eta_g * wo_lx + (eta_g * cti_r - ctt) * fhx
        gty = -eta_g * wo_ly + (eta_g * cti_r - ctt) * fhy
        gtz = -eta_g * wo_lz + (eta_g * cti_r - ctt) * fhz
        # _glass_trans_f (bxdf.py:230-249)
        not_trans = gtz * wo_lz > 0.0
        eta_t2 = jnp.where(wo_lz > 0.0, ior_i / ior_o, ior_o / ior_i)
        thx, thy, thz, _ = _normalize3(wo_lx + gtx * eta_t2,
                                       wo_ly + gty * eta_t2,
                                       wo_lz + gtz * eta_t2)
        tsg = jnp.where(thz < 0.0, -1.0, 1.0)
        thx2, thy2, thz2 = thx * tsg, thy * tsg, thz * tsg
        fr_t = _fr_dielectric(thx2 * wo_lx + thy2 * wo_ly + thz2 * wo_lz,
                              ior_i, ior_o)
        dot_ot = thx2 * wo_lx + thy2 * wo_ly + thz2 * wo_lz
        dot_it = thx2 * gtx + thy2 * gty + thz2 * gtz
        sqrt_den = dot_ot + eta_t2 * dot_it
        den_t = gtz * wo_lz * sqrt_den * sqrt_den
        num_t = (_d_beckmann(thx2, thy2, thz2, ax_m)
                 * (1.0 / (1.0 + _lambda_beckmann(wo_lx, wo_ly, wo_lz,
                                                  ax_m)
                    + _lambda_beckmann(gtx, gty, gtz, ax_m)))
                 * jnp.abs(dot_it) * jnp.abs(dot_ot))
        f_gt = (1.0 - fr_t) * jnp.abs(num_t / _safe_div(den_t))
        bad_t = (not_trans | (jnp.abs(gtz) < 1e-7)
                 | (jnp.abs(wo_lz) < 1e-7))
        f_gt = jnp.where(bad_t, 0.0, f_gt)
        # _glass_trans_pdf (bxdf.py:252-261): UNFLIPPED wh
        dot_ot3 = thx * wo_lx + thy * wo_ly + thz * wo_lz
        dot_it3 = thx * gtx + thy * gty + thz * gtz
        sd3 = dot_ot3 + eta_t2 * dot_it3
        dwh_dwi = jnp.abs(eta_t2 * eta_t2 * dot_it3) \
            / jnp.maximum(sd3 * sd3, 1e-12)
        pdf_gt = _d_beckmann(thx, thy, thz, ax_m) * jnp.abs(thz) * dwh_dwi
        pdf_gt = jnp.where(not_trans, 0.0, pdf_gt)
        f_gt = jnp.where(gt_ok, f_gt, 0.0)
        pdf_gt = jnp.where(gt_ok, pdf_gt, 0.0)
        # branch select
        gwx = jnp.where(g_refl, grx, gtx)
        gwy = jnp.where(g_refl, gry, gty)
        gwz = jnp.where(g_refl, grz, gtz)
        f_gl = jnp.where(g_refl, f_gr, f_gt)
        pdf_gl = jnp.where(g_refl, pdf_gr, pdf_gt)
        wlx = jnp.where(is_gl, gwx, wlx)
        wly = jnp.where(is_gl, gwy, wly)
        wlz = jnp.where(is_gl, gwz, wlz)
        fs_r = jnp.where(is_gl, f_gl, fs_r)
        fs_g = jnp.where(is_gl, f_gl, fs_g)
        fs_b = jnp.where(is_gl, f_gl, fs_b)
        pdf_s = jnp.where(is_gl, pdf_gl, pdf_s)
        is_glossy = is_glossy | is_gl
    dead = (pdf_s <= 0.0) | ((fs_r == 0.0) & (fs_g == 0.0) & (fs_b == 0.0))
    wwx = wlx * ftx + wly * fbx + wlz * fnx
    wwy = wlx * fty + wly * fby + wlz * fny
    wwz = wlx * ftz + wly * fbz + wlz * fnz
    w_cos = jnp.abs(wwx * fnx + wwy * fny + wwz * fnz)
    w_scale = w_cos / jnp.maximum(pdf_s, 1e-12)
    nbx = jnp.where(cont, bx * (fs_r * w_scale), bx)
    nby = jnp.where(cont, by * (fs_g * w_scale), by)
    nbz = jnp.where(cont, bz * (fs_b * w_scale), bz)

    # ---- Russian roulette (trace.h:512-525)
    max_c = jnp.maximum(jnp.maximum(nbx, nby), nbz)
    q = jnp.maximum(0.05, 1.0 - max_c)
    rr_active = cont & (bounce > rr_start)
    rr_kill = rr_active & (u_rr < q)
    rr_boost = rr_active & ~rr_kill
    inv_q = 1.0 / jnp.maximum(1.0 - q, 1e-6)
    nbx = jnp.where(rr_boost, nbx * inv_q, nbx)
    nby = jnp.where(rr_boost, nby * inv_q, nby)
    nbz = jnp.where(rr_boost, nbz * inv_q, nbz)

    new_alive = cont & ~dead & ~rr_kill
    side2 = jnp.where((wwx * nx + wwy * ny + wwz * nz) >= 0.0, 1.0, -1.0)
    return {
        "l_add": (l_add_r, l_add_g, l_add_b),
        "good_inc": good_inc,
        "want_shadow": want_shadow,
        "new_o": (jnp.where(new_alive, px + nx * eps * side2, 3.0e18),
                  jnp.where(new_alive, py + ny * eps * side2, 3.0e18),
                  jnp.where(new_alive, pz + nz * eps * side2, 3.0e18)),
        "new_d": (jnp.where(new_alive, wwx, 1.0),
                  jnp.where(new_alive, wwy, 0.0),
                  jnp.where(new_alive, wwz, 0.0)),
        "new_beta": (nbx, nby, nbz),
        "new_alive": new_alive,
        "new_prev_sg": jnp.where(cont, is_spec | is_glossy, prev_sg),
    }


def production_fast_shade(scene: T.Scene, camera=None, film=None,
                          estimator: str = "reference",
                          trace_type: str = "PATHTRACE"):
    """THE fast-path decision, shared by the Renderer, the benchmarks and
    chip_smoke.py: "bounce" (the whole-pass megakernel) or False (the XLA
    wavefront). The kernel is compiled for the GPU only; every other
    backend renders through XLA. With camera/film given, the in-kernel
    raygen gates apply too."""
    if jax.default_backend() != "gpu":
        return False
    if estimator not in ("reference", "physical"):
        return False
    if trace_type != "PATHTRACE":
        return False
    if not fast_shade_mode(scene):
        return False
    if camera is not None and film is not None:
        from craytracer_tpu.camera import PINHOLE, THINLENS

        # the in-kernel raygen covers pinhole + thin-lens and needs
        # f32-exact pixel ids
        if (camera.camera_type not in (PINHOLE, THINLENS)
                or film.width * film.height > (1 << 24)):
            return False
    return "bounce"


def fast_shade_mode(scene: T.Scene):
    """Host-side (outside jit): "bounce" when the whole-pass megakernel
    covers the scene (brute-force geometry, <= 64 primitives, the
    materials and lights of `fast_shade_ok`), else False."""
    if not fast_shade_ok(scene):
        return False
    n_inst = scene.instanced.mat_id.shape[0]
    # instanced rows join the prim table only when ALL are AABOX
    # (cylinders and tori stay on the XLA path)
    if n_inst and not bool(
            (np.asarray(scene.instanced.kind) == T.INST_AABOX).all()):
        return False
    n_prims = sum(getattr(scene, g).mat_id.shape[0]
                  for g in ("spheres", "planes", "rects", "disks",
                            "triangles", "instanced"))
    if n_prims > 64:
        return False
    if (scene.tri_bvh is not None or scene.sph_bvh is not None
            or scene.tri_cam is not None):
        return False
    if np.asarray(scene.triangles.smooth).any():
        return False
    # the kernel's cosine-space sphere clip window is equivalent to
    # |atan2| <= phi only for phi in [0, pi] and theta in [0, pi]; the
    # parser accepts anything (e.g. PHI 6.283 spells a full sphere), so
    # out-of-domain clips stay on the XLA intersect
    if scene.spheres.mat_id.shape[0]:
        sp = np.asarray(scene.spheres.phi)
        mn = np.asarray(scene.spheres.min_theta)
        mx = np.asarray(scene.spheres.max_theta)
        eps = 1e-5
        if not ((sp <= np.pi + eps).all()
                and (mn >= -eps).all() and (mn <= np.pi + eps).all()
                and (mx >= -eps).all() and (mx <= np.pi + eps).all()):
            return False
    return "bounce"


def fast_shade_ok(scene: T.Scene) -> bool:
    """Host-side material/light/texture gate of the megakernel. Reads
    concrete table values, so a traced scene (inside jit) never takes the
    kernel."""
    if any(isinstance(x, jax.core.Tracer) for x in jax.tree.leaves(scene)):
        return False
    mats = set(scene.mat_types_present)
    if not mats <= {T.MAT_MATTE, T.MAT_EMISSIVE, T.MAT_MIRROR,
                    T.MAT_PLASTIC, T.MAT_METAL, T.MAT_GLASS,
                    T.MAT_TRANSPARENT}:
        return False
    if mats & {T.MAT_PLASTIC, T.MAT_METAL, T.MAT_GLASS}:
        # microfacet lanes: the kernel ports the ISOTROPIC BECKMANN
        # inversion only (reference scenes always build Beckmann)
        is_mf = np.isin(np.asarray(scene.materials.mat_type),
                        [T.MAT_PLASTIC, T.MAT_METAL, T.MAT_GLASS])
        ax = np.asarray(scene.materials.alphax)[is_mf]
        ay = np.asarray(scene.materials.alphay)[is_mf]
        di = np.asarray(scene.materials.distrib)[is_mf]
        if (ax != ay).any() or (di != T.DIST_BECKMANN).any():
            return False
    if scene.textures.texels.shape[0] > 1:
        return False
    if scene.env.kind not in (0, 1) or getattr(scene.env, "importance", 0):
        return False
    n_lights = scene.lights.light_type.shape[0]
    if n_lights == 0 or n_lights > 16:
        return False
    if scene.materials.mat_type.shape[0] > 64:
        return False
    ltype = np.asarray(scene.lights.light_type)
    power = np.asarray(scene.lights.power)
    # every row that can actually be picked must be a rect or sphere
    # area light (the two NEE samplers the kernel implements)
    ok_rows = ((ltype == T.LIGHT_AREA_RECT)
               | (ltype == T.LIGHT_AREA_SPHERE))
    if (power[~ok_rows] > 0.0).any():
        return False
    return True


def lane_block(n: int, block: int = PASS_BLOCK) -> int:
    """Lanes per program for an n-lane pass: `block` (a power of two),
    shrunk to the next power of two above n for small passes so tiny
    launches do not trace mostly padding. At least 16 lanes."""
    if block < 1 or block & (block - 1):
        raise ValueError(f"lane block must be a power of two, got {block}")
    return max(16, min(block, 1 << max(n - 1, 0).bit_length()))


def _meta_operands(scene: T.Scene):
    env_li = (scene.env.color * scene.env.intensity
              if scene.env.kind == 1 else jnp.zeros((3,), jnp.float32))
    sf = jnp.concatenate([env_li.astype(jnp.float32),
                          jnp.zeros((1,), jnp.float32)])
    m = scene.materials
    # 19 cols: 0 type, 1-3 color, 4 on_a, 5 intensity, 6 on_b, 7 alphax,
    # 8-10 ks, 11-13 eta, 14-16 k, 17 ior_in, 18 ior_out
    mt = jnp.stack([m.mat_type.astype(jnp.float32), m.color[:, 0],
                    m.color[:, 1], m.color[:, 2], m.on_a, m.intensity,
                    m.on_b, m.alphax,
                    m.ks[:, 0], m.ks[:, 1], m.ks[:, 2],
                    m.eta[:, 0], m.eta[:, 1], m.eta[:, 2],
                    m.k[:, 0], m.k[:, 1], m.k[:, 2],
                    m.ior_in, m.ior_out],
                   axis=-1)
    li_tab = scene.lights
    li_rgb = li_tab.color * li_tab.intensity[:, None]
    lt = jnp.concatenate([
        li_tab.p0, li_tab.v1, li_tab.v2, li_tab.normal, li_rgb,
        li_tab.radius[:, None],                     # 15: sphere radius
        li_tab.power_cdf[:, None], li_tab.power[:, None],
        li_tab.light_type[:, None].astype(jnp.float32),  # 18: LIGHT_*
    ], axis=-1)
    return sf, mt, lt


def _prim_tables(scene: T.Scene):
    """(pt, bt): the primitive table, 16 cols, rows packed in
    intersect_scene's group order (sphere, plane, rect, disk, triangle):
    A = cols 0-2 (sphere center / plane point / rect point / disk center /
    tri v0), B = cols 3-5 (radius+clip / rect width / tri e1; ZERO for
    plane/disk so the shade frame's Duff fallback = orthonormal_basis),
    cols 6-8 (clip / rect height / disk radius in col 6 / tri e2),
    N = cols 9-11 (normal), 12 mat_id, 13 double_sided; and the instanced
    AABOX table, 25 cols: 0-11 inv_transform [3,4] row-major, 12-20
    normal_mat [3,3] row-major, 21-23 half extents, 24 mat_id (the gate
    admits only all-AABOX instanced sets)."""
    n_box = scene.instanced.mat_id.shape[0]
    if n_box:
        inst = scene.instanced
        bt = jnp.concatenate([
            inst.inv_transform.reshape(n_box, 12),
            inst.normal_mat.reshape(n_box, 9),
            inst.params[:, 0:3] * 0.5,
            inst.mat_id[:, None].astype(jnp.float32),
        ], axis=-1)
    else:
        bt = jnp.zeros((1, 25), jnp.float32)
    s = scene.spheres
    n_sph = s.mat_id.shape[0]
    zero_s = jnp.zeros((n_sph, 1), jnp.float32)
    pt_sph = jnp.concatenate([
        s.center, s.radius[:, None], jnp.cos(s.phi)[:, None],
        jnp.cos(s.min_theta)[:, None], jnp.cos(s.max_theta)[:, None],
        zero_s, zero_s,
        jnp.zeros((n_sph, 3), jnp.float32),
        s.mat_id[:, None].astype(jnp.float32), zero_s, zero_s, zero_s,
    ], axis=-1)
    p = scene.planes
    n_pl = p.mat_id.shape[0]
    zero_p3 = jnp.zeros((n_pl, 3), jnp.float32)
    zero_p = jnp.zeros((n_pl, 1), jnp.float32)
    pt_pl = jnp.concatenate([
        p.point, zero_p3, zero_p3, p.normal,
        p.mat_id[:, None].astype(jnp.float32), zero_p, zero_p, zero_p,
    ], axis=-1)
    r = scene.rects
    zero_r = jnp.zeros((r.mat_id.shape[0], 1), jnp.float32)
    pt_rect = jnp.concatenate([
        r.point, r.width, r.height, r.normal,
        r.mat_id[:, None].astype(jnp.float32), zero_r, zero_r, zero_r,
    ], axis=-1)
    dk = scene.disks
    n_dsk = dk.mat_id.shape[0]
    zero_d3 = jnp.zeros((n_dsk, 3), jnp.float32)
    zero_d = jnp.zeros((n_dsk, 1), jnp.float32)
    pt_dsk = jnp.concatenate([
        dk.center, zero_d3, dk.radius[:, None], zero_d, zero_d,
        dk.normal,
        dk.mat_id[:, None].astype(jnp.float32), zero_d, zero_d, zero_d,
    ], axis=-1)
    tr = scene.triangles
    zero_t = jnp.zeros((tr.mat_id.shape[0], 1), jnp.float32)
    pt_tri = jnp.concatenate([
        tr.v0, tr.v1 - tr.v0, tr.v2 - tr.v0, tr.face_normal,
        tr.mat_id[:, None].astype(jnp.float32),
        tr.double_sided[:, None].astype(jnp.float32), zero_t, zero_t,
    ], axis=-1)
    pt = jnp.concatenate([pt_sph, pt_pl, pt_rect, pt_dsk, pt_tri], axis=0)
    return pt, bt


def _camera_table(camera, film):
    from craytracer_tpu.camera import film_dims

    fl, fh, pxl = film_dims(film, camera)
    return jnp.concatenate([
        camera.position, camera.x_axis, camera.y_axis, camera.z_axis,
        jnp.stack([jnp.asarray(camera.focal_dist, jnp.float32),
                   jnp.asarray(fl, jnp.float32),
                   jnp.asarray(fh, jnp.float32),
                   jnp.asarray(pxl, jnp.float32),
                   jnp.asarray(camera.focal_length, jnp.float32),
                   jnp.asarray(camera.lens_radius, jnp.float32)]),
    ]).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("max_depth", "rr_start",
                                             "interpret", "block",
                                             "raygen", "width"))
def fused_pass(scene: T.Scene, o, d, pix, spp, seed,
               max_depth: int, rr_start: int = 3,
               interpret: bool = False, block: int = PASS_BLOCK,
               raygen: str | None = None, camera=None, film=None,
               width: int = 0):
    """Whole-pass megakernel (see _pass_kernel): the full bounce loop in
    ONE launch for brute-force scenes. Returns (L[N,3], good[N],
    metrics dict with rays/shadow_rays scalars and bounce_live
    histogram) — the trace_paths contract.

    With `raygen` ("plain" = CAMERA_BOUNCE uniforms jitter, "strat" =
    production stratified_jitter) + `camera`/`film` (+ static `width`),
    the camera raygen also runs in-kernel and `o`/`d` are ignored (pass
    None) — the launch consumes only pixel ids. `interpret=True` runs the
    kernel in the Pallas interpreter (tests on the CPU)."""
    n = pix.shape[0]
    prim_counts = tuple(getattr(scene, g).mat_id.shape[0]
                        for g in ("spheres", "planes", "rects", "disks",
                                  "triangles"))
    n_box = scene.instanced.mat_id.shape[0]
    sf, mt, lt = _meta_operands(scene)
    pt, bt = _prim_tables(scene)
    seed_a = jnp.asarray(seed, jnp.int32).reshape((1,))

    blk = lane_block(n, block)
    pad = (-n) % blk
    npad = n + pad
    # padded lanes re-trace pixel 0 (results sliced away)
    pix_a = jnp.pad(pix.astype(jnp.int32), (0, pad))
    spp_a = jnp.broadcast_to(jnp.asarray(spp, jnp.int32), (n,))
    spp_a = jnp.pad(spp_a, (0, pad))
    lane_spec = pl.BlockSpec((blk,), lambda i: (i,))
    rows_spec = pl.BlockSpec((4, blk), lambda i: (0, i))
    if raygen is None:
        # rows 0-2 origin, 3-5 direction, 6-7 unused (power-of-two rows).
        # Padded lanes carry a true +x ESCAPE ray (origin 3e18, direction
        # (1,0,0) — the wavefront convention): every prim test misses, so
        # pads do no real work.
        rays = jnp.concatenate([o.T, d.T, jnp.zeros((2, n), jnp.float32)])
        pad_rays = jnp.zeros((8, pad), jnp.float32)
        pad_rays = pad_rays.at[0:3].set(3.0e18).at[3].set(1.0)
        ray_in = jnp.concatenate([rays.astype(jnp.float32), pad_rays],
                                 axis=1)
        ray_spec = pl.BlockSpec((8, blk), lambda i: (0, i))
    else:
        ray_in = _camera_table(camera, film)
        ray_spec = pl.BlockSpec()

    statics = dict(n_mats=scene.materials.mat_type.shape[0],
                   n_lights=scene.lights.light_type.shape[0],
                   prim_counts=prim_counts, n_box=n_box,
                   max_depth=max_depth, rr_start=rr_start,
                   has_mirror=T.MAT_MIRROR in scene.mat_types_present,
                   has_sphere_light=T.LIGHT_AREA_SPHERE
                   in scene.light_types_present,
                   has_oren=(T.MAT_MATTE in scene.mat_types_present
                             and not scene.matte_lambertian),
                   has_plastic=T.MAT_PLASTIC in scene.mat_types_present,
                   has_metal=T.MAT_METAL in scene.mat_types_present,
                   has_glass=T.MAT_GLASS in scene.mat_types_present,
                   has_transparent=T.MAT_TRANSPARENT
                   in scene.mat_types_present,
                   raygen=raygen, width=width,
                   thinlens=(camera is not None
                             and getattr(camera, "camera_type", 0) != 0))
    whole = pl.BlockSpec()
    lo, go = pl.pallas_call(
        functools.partial(_pass_kernel, **statics),
        grid=(npad // blk,),
        in_specs=[whole, whole, whole, whole, whole, whole,
                  ray_spec, lane_spec, lane_spec],
        out_specs=[rows_spec, rows_spec],
        out_shape=[jax.ShapeDtypeStruct((4, npad), jnp.float32),
                   jax.ShapeDtypeStruct((4, npad), jnp.int32)],
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, blk // LANES_PER_WARP), num_stages=1),
        interpret=interpret,
        backend="triton",
        name="fused_pass",
    )(seed_a, sf, mt, lt, pt, bt, ray_in, pix_a, spp_a)
    L = lo[:3, :n].T
    good = go[0, :n]
    hist = go[3, :n]
    bounce_live = jnp.stack([
        jnp.sum((hist >> b) & 1) for b in range(max_depth + 1)])
    metrics = {"rays": jnp.sum(go[1, :n]),
               "shadow_rays": jnp.sum(go[2, :n]),
               "bounce_live": bounce_live}
    return L, good, metrics
