"""Batched ray-primitive intersection (wavefront "traverse + fill" stages).

Re-design of the reference's per-object dispatch (`shapes/shapes.cpp:4-96`,
`intersect.h:365-545`) as two phases over `[N]` ray batches:

1. **search**: for every primitive group, compute candidate hit distances for
   all (ray, primitive) pairs as one fused `[N, M]` computation, reduce to the
   per-group argmin, then reduce across groups. No ShadeRec is materialized.
2. **fill**: gather the single winning primitive per ray and reconstruct the
   hit attributes (normal, uv, dpdu) — the SoA equivalent of
   `fillShadeRec*` — touching each ray exactly once.

Shadow (any-hit) queries run only phase 1 against a distance bound
(`shadowIntersectTest`, intersect.h:443-545).

Primitive-specific semantics are kept bit-compatible with the reference
where visible in images (clipping windows, normal-facing rules, uv
conventions); citations inline. This brute-force module is also the ground
truth that the accelerated traversals (accel/) are tested against.
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax
import jax.numpy as jnp

from craytracer_tpu.constants import K_EPSILON, TMAX, TWO_PI
from craytracer_tpu.core import math as vm
from craytracer_tpu.core.solvers import solve_quadratic, solve_quartic
from craytracer_tpu.scene import types as T


@struct.dataclass
class Hit:
    """SoA hit record — the wavefront ShadeRec (util/shaderec.h:7-19)."""

    t: jnp.ndarray  # [N]
    group: jnp.ndarray  # [N] int32 GROUP_*, -1 for miss
    prim: jnp.ndarray  # [N] int32 index within group
    point: jnp.ndarray  # [N, 3]
    normal: jnp.ndarray  # [N, 3] shading normal (facing per-prim rules)
    dpdu: jnp.ndarray  # [N, 3] surface tangent for the shading frame
    uv: jnp.ndarray  # [N, 2]
    mat_id: jnp.ndarray  # [N] int32

    @property
    def hit_mask(self):
        return self.t < TMAX


def _pair(o, d, prim_o):
    """Broadcast rays [N,3] against per-prim vectors [M,3] -> [N,M,3]."""
    return o[:, None, :], d[:, None, :], prim_o[None, :, :]


# ---------------------------------------------------------------------------
# Per-group candidate distances, [N, M].


def sphere_ts(o, d, s: T.Spheres):
    """Partial-sphere hit distances (rayIntersectSphere, shapes/sphere.cpp:33-86):
    quadratic roots, each accepted only inside the phi/theta clip window."""
    # Per-component [N,1] x [1,M] layout (see triangle_ts).
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    cx, cy, cz = (s.center[None, :, 0], s.center[None, :, 1],
                  s.center[None, :, 2])
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - (s.radius * s.radius)[None, :]
    _, t0, t1 = solve_quadratic(a, b, c)

    def accept(t):
        hx = ox + t * dx - cx
        hy = oy + t * dy - cy
        hz = oz + t * dz - cz
        # reference phi convention: atan2(x, z) (sphere.cpp:56,110)
        phi = jnp.arctan2(hx, hz)
        cos_raw = hy / s.radius[None, :]
        theta = jnp.arccos(jnp.clip(cos_raw, -1.0, 1.0))
        ok = (
            (t > K_EPSILON)
            & (t < TMAX)
            & (jnp.abs(phi) <= s.phi[None, :])
            & (theta >= s.min_theta[None, :])
            & (theta <= s.max_theta[None, :])
            # Reference quirk: acos((y-cy)/r) is UNCLAMPED (sphere.cpp:57,
            # 111); f32 rounding past +-1 gives NaN and the clip comparison
            # REJECTS the hit. Rejecting |cos|>1 here reproduces the same
            # near-pole miss statistics (exact per-ray agreement is f32
            # luck, but the leak probability matches in expectation).
            & (jnp.abs(cos_raw) <= 1.0)
        )
        return jnp.where(ok, t, TMAX)

    return jnp.minimum(accept(t0), accept(t1))


def plane_ts(o, d, p: T.Planes):
    """rayIntersectPlane (shapes/plane.cpp:4-19). Per-component layout
    (see triangle_ts)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px_, py_, pz_ = (p.point[None, :, 0], p.point[None, :, 1],
                     p.point[None, :, 2])
    nx, ny, nz = (p.normal[None, :, 0], p.normal[None, :, 1],
                  p.normal[None, :, 2])
    denom = dx * nx + dy * ny + dz * nz
    t = ((px_ - ox) * nx + (py_ - oy) * ny + (pz_ - oz) * nz) \
        / vm._safe(denom)
    return jnp.where(t > K_EPSILON, t, TMAX)


def rect_ts(o, d, r: T.Rects):
    """rayIntersectRect (shapes/rect.cpp:3-54): plane hit + edge
    projections. Per-component layout (see triangle_ts): [N,1] x [1,M]
    keeps the primitive count in the 128-lane minor dim."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]          # [N, 1]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    pxr, pyr, pzr = (r.point[None, :, 0], r.point[None, :, 1],
                     r.point[None, :, 2])                 # [1, M]
    nx, ny, nz = (r.normal[None, :, 0], r.normal[None, :, 1],
                  r.normal[None, :, 2])
    wx, wy, wz = (r.width[None, :, 0], r.width[None, :, 1],
                  r.width[None, :, 2])
    hx, hy, hz = (r.height[None, :, 0], r.height[None, :, 1],
                  r.height[None, :, 2])
    denom = dx * nx + dy * ny + dz * nz
    t = ((pxr - ox) * nx + (pyr - oy) * ny + (pzr - oz) * nz) \
        / vm._safe(denom)
    qx = ox + t * dx - pxr
    qy = oy + t * dy - pyr
    qz = oz + t * dz - pzr
    u = (qx * wx + qy * wy + qz * wz) / (wx * wx + wy * wy + wz * wz)
    v = (qx * hx + qy * hy + qz * hz) / (hx * hx + hy * hy + hz * hz)
    ok = (t > K_EPSILON) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    return jnp.where(ok, t, TMAX)


def disk_ts(o, d, k: T.Disks):
    """rayIntersectDisk (shapes/disk.cpp:3-32). Per-component layout
    (see triangle_ts)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    cx, cy, cz = (k.center[None, :, 0], k.center[None, :, 1],
                  k.center[None, :, 2])
    nx, ny, nz = (k.normal[None, :, 0], k.normal[None, :, 1],
                  k.normal[None, :, 2])
    denom = dx * nx + dy * ny + dz * nz
    t = ((cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz) \
        / vm._safe(denom)
    qx = ox + t * dx - cx
    qy = oy + t * dy - cy
    qz = oz + t * dz - cz
    ok = (t > K_EPSILON) & ((qx * qx + qy * qy + qz * qz)
                            <= (k.radius * k.radius)[None, :])
    return jnp.where(ok, t, TMAX)


def triangle_ts(o, d, tr: T.Triangles, v0=None, e1=None, e2=None):
    """Moller-Trumbore over [N, M] pairs — the batched replacement for
    calcTriangleIntersect (shapes/triangle.cpp:14-79) and the 4-wide SSE
    kernel (shapes/triangle.cpp:81-151). Returns (t, beta, gamma).

    Written PER-COMPONENT ([N,1] ray columns against [1,M] triangle
    rows) rather than over [N,M,3] vectors: no 3-wide minor dimension is
    ever materialized. This brute-force path IS the hot path for small
    scenes on the XLA route (cornell = 20 tris)."""
    if v0 is None:
        v0 = tr.v0
        e1 = tr.v1 - tr.v0
        e2 = tr.v2 - tr.v0
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]          # [N, 1]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]  # [1, M]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
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
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0) & (t > K_EPSILON)
    return jnp.where(ok, t, TMAX), beta, gamma


def _instanced_object_rays(o, d, inst: T.Instanced):
    """Pull world rays into each instance's object space
    (transformRay in rayIntersectInstanced, shapes/instanced.cpp:48-105).
    Direction is NOT renormalized so `t` parametrizes the world ray."""
    a = inst.inv_transform[None, :, :, :3]  # [1, M, 3, 3]
    b = inst.inv_transform[None, :, :, 3]  # [1, M, 3]
    oo = vm.mat3_apply(a, o[:, None, :]) + b  # [N, M, 3]
    od = vm.mat3_apply(a, d[:, None, :])
    return oo, od


def _aabox_ts(oo, od, half):
    """Canonical centered box [-half, half] (initBox, shapes/box.cpp:4-20;
    rayIntersectAABox, shapes/generic.cpp:311-418): enter if outside,
    exit face if inside."""
    inv = 1.0 / vm._safe(od)
    t0 = (-half - oo) * inv
    t1 = (half - oo) * inv
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    ok = (tn < tf) & (tf > K_EPSILON)
    t = jnp.where(tn > K_EPSILON, tn, tf)
    return jnp.where(ok, t, TMAX)


def _cyl_ts(oo, od, phi_max, radius=1.0, half_h=1.0):
    """Canonical open cylinder (rayIntersectGenericOpenCylinder,
    shapes/generic.cpp:34-80): radius 1, |y| <= 1, |atan2(x, z)| <= phi."""
    a = od[..., 0] ** 2 + od[..., 2] ** 2
    b = 2.0 * (oo[..., 0] * od[..., 0] + oo[..., 2] * od[..., 2])
    c = oo[..., 0] ** 2 + oo[..., 2] ** 2 - radius * radius
    _, t0, t1 = solve_quadratic(a, b, c)

    def accept(t):
        hp = oo + t[..., None] * od
        phi = jnp.arctan2(hp[..., 0], hp[..., 2])
        ok = (
            (t > K_EPSILON)
            & (t < TMAX)
            & (jnp.abs(hp[..., 1]) <= half_h)
            & (jnp.abs(phi) <= phi_max)
        )
        return jnp.where(ok, t, TMAX)

    return jnp.minimum(accept(t0), accept(t1))


def _cap_ts(oo, od, radius, y):
    """Disk cap at height y with normal +-y (initCompoundSolidCylinder,
    shapes/cylinder.cpp:36-60)."""
    n_sign = jnp.sign(y)
    denom = od[..., 1] * n_sign
    t = (y - oo[..., 1]) * n_sign / vm._safe(denom)
    hp_x = oo[..., 0] + t * od[..., 0]
    hp_z = oo[..., 2] + t * od[..., 2]
    ok = (t > K_EPSILON) & (hp_x * hp_x + hp_z * hp_z <= radius * radius)
    return jnp.where(ok, t, TMAX)


def _torus_ts(oo, od, swept, tube, phi_max):
    """Canonical torus quartic (rayIntersectGenericTorus,
    shapes/generic.cpp:156-222), with the phi clip applied as intended (the
    reference's clip is inert due to a fall-through return)."""
    sum_d = vm.dot(od, od)
    e = vm.dot(oo, oo) - swept * swept - tube * tube
    f = vm.dot(oo, od)
    four_a2 = 4.0 * swept * swept
    c4 = sum_d * sum_d
    c3 = 4.0 * sum_d * f
    c2 = 2.0 * sum_d * e + 4.0 * f * f + four_a2 * od[..., 1] ** 2
    c1 = 4.0 * f * e + 2.0 * four_a2 * oo[..., 1] * od[..., 1]
    c0 = e * e - four_a2 * (tube * tube - oo[..., 1] ** 2)
    inv = 1.0 / vm._safe(c4)
    roots, valid = solve_quartic(c3 * inv, c2 * inv, c1 * inv, c0 * inv, newton_iters=3)
    roots = jnp.where(valid & (roots > K_EPSILON), roots, TMAX)
    t = jnp.min(roots, axis=-1)
    hp = oo + t[..., None] * od
    phi = jnp.arctan2(hp[..., 0], hp[..., 2])
    ok = (t < TMAX) & (jnp.abs(phi) <= phi_max)
    return jnp.where(ok, t, TMAX)


def instanced_ts(o, d, inst: T.Instanced):
    """[N, M] distances for instanced prims: every kind's formula runs for
    every instance, masked by kind — the switch-free wavefront dispatch."""
    oo, od = _instanced_object_rays(o, d, inst)
    p = inst.params[None, :, :]
    kind = inst.kind[None, :]
    t_box = _aabox_ts(oo, od, p[..., 0:3] / 2.0)
    t_cyl = _cyl_ts(oo, od, p[..., 0])
    t_tor = _torus_ts(oo, od, p[..., 0], p[..., 1], p[..., 2])
    t_cap = _cap_ts(oo, od, p[..., 0], p[..., 1])
    t = jnp.where(kind == T.INST_AABOX, t_box, TMAX)
    t = jnp.where(kind == T.INST_OPEN_CYLINDER, t_cyl, t)
    t = jnp.where(kind == T.INST_TORUS, t_tor, t)
    t = jnp.where(kind == T.INST_DISK, t_cap, t)
    return t


# ---------------------------------------------------------------------------
# Phase 2: attribute fill for the winning primitive of each group.
#
# Each fill also returns a DIFFERENTIABLE re-derivation of the hit distance
# for the (detached) winning primitive, via one implicit-function Newton
# step: t_diff = t0 - F(t0, theta) / F'(t0) with t0 = detach(t) and F the
# primitive's along-ray implicit. Forward value is unchanged (F(t0) ~ 0);
# backward yields the exact first-order dt/dtheta — this is SURVEY.md §7's
# "custom VJPs that replay from saved hit records" realized through jax AD.


def _take(arr, idx):
    return jnp.take(arr, idx, axis=0)


# All fills fetch their per-primitive attributes with ONE fused lookup
# (ops/gather.py) instead of one gather per field.
from craytracer_tpu.ops.gather import take_rows


def _newton_t(t0, F, Fp):
    """One implicit-function step; Fp is detached to keep it a pure
    reparametrization (value preserved, gradient = -F_theta / F_t)."""
    denom = vm._safe(jax.lax.stop_gradient(Fp))
    return t0 - F / denom


def _fill_sphere(o, d, t, idx, s: T.Spheres):
    c, r, mat_id = take_rows(idx, (s.center, s.radius, s.mat_id))
    # implicit: F(t) = |o + t d - c|^2 - r^2
    oc = o + t[:, None] * d - c
    F = vm.dot(oc, oc) - r * r
    Fp = 2.0 * vm.dot(oc, d)
    t_diff = _newton_t(t, F, Fp)
    hp = o + t_diff[:, None] * d
    n = vm.normalize(hp - c)
    rel = hp - c
    phi = jnp.arctan2(rel[:, 0], rel[:, 2])  # atan2(x, z), sphere.cpp:23
    phi_w = jnp.where(phi < 0, phi + TWO_PI, phi)
    # strictly-interior clip: at a saturated +-1, arccos'(x) = -inf and
    # clip' = 0, so the chain rule yields inf * 0 = NaN — which poisons the
    # WHOLE batch through the fill where-combines in reverse mode
    theta = jnp.arccos(jnp.clip(rel[:, 1] / vm._safe(r), -1.0 + 1e-6, 1.0 - 1e-6))
    uv = jnp.stack([phi_w / TWO_PI, theta / jnp.pi], axis=-1)
    # dpdu ~ (-(z-cz), 0, (x-cx)) (fillShadeRecSphere, shapes/sphere.cpp:4-31)
    dpdu = vm.normalize(jnp.stack([-rel[:, 2], jnp.zeros_like(t), rel[:, 0]], axis=-1))
    return n, dpdu, uv, mat_id, t_diff


def _fill_plane(o, d, t, idx, p: T.Planes):
    n, p0, mat_id = take_rows(idx, (p.normal, p.point, p.mat_id))
    t_diff = vm.dot(p0 - o, n) / vm._safe(vm.dot(d, n))
    tang, _, _ = vm.orthonormal_basis(n)
    uv = jnp.zeros((t.shape[0], 2), t.dtype)
    return n, tang, uv, mat_id, t_diff


def _fill_rect(o, d, t, idx, r: T.Rects):
    n, w, h, p0, mat_id = take_rows(
        idx, (r.normal, r.width, r.height, r.point, r.mat_id))
    t_diff = vm.dot(p0 - o, n) / vm._safe(vm.dot(d, n))
    hp = o + t_diff[:, None] * d
    q = hp - p0
    u = vm.dot(q, w) / vm.dot(w, w)
    v = vm.dot(q, h) / vm.dot(h, h)
    # Face the normal toward wo, negating dpdu with it (rect.cpp:36-46).
    flip = vm.dot(-d, n) < 0.0
    n = jnp.where(flip[:, None], -n, n)
    dpdu = vm.normalize(jnp.where(flip[:, None], -w, w))
    return n, dpdu, jnp.stack([u, v], axis=-1), mat_id, t_diff


def _fill_disk(o, d, t, idx, k: T.Disks):
    n, c0, mat_id = take_rows(idx, (k.normal, k.center, k.mat_id))
    t_diff = vm.dot(c0 - o, n) / vm._safe(vm.dot(d, n))
    flip = vm.dot(-d, n) < 0.0
    n = jnp.where(flip[:, None], -n, n)
    tang, _, _ = vm.orthonormal_basis(n)
    uv = jnp.zeros((t.shape[0], 2), t.dtype)
    return n, tang, uv, mat_id, t_diff


def _fill_triangle(o, d, t, idx, tr: T.Triangles):
    (v0, v1, v2, tn0, tn1, tn2, tuv0, tuv1, tuv2, fn, smooth, ds,
     mat_id) = take_rows(idx, (tr.v0, tr.v1, tr.v2, tr.n0, tr.n1, tr.n2,
                               tr.uv0, tr.uv1, tr.uv2, tr.face_normal,
                               tr.smooth, tr.double_sided, tr.mat_id))
    e1 = v1 - v0
    e2 = v2 - v0
    # Recompute barycentrics for the single winning triangle.
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    inv_det = 1.0 / vm._safe(det)
    tvec = o - v0
    beta = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    gamma = vm.dot(d, qvec) * inv_det
    t_diff = vm.dot(e2, qvec) * inv_det  # exact differentiable MT re-eval
    alpha = 1.0 - beta - gamma
    ns = vm.normalize(
        alpha[:, None] * tn0 + beta[:, None] * tn1 + gamma[:, None] * tn2
    )
    n = jnp.where(smooth[:, None], ns, fn)
    # Standalone triangles face the ray (shapes/triangle.cpp:160-166).
    flip = ds & (vm.dot(-d, n) < 0.0)
    n = jnp.where(flip[:, None], -n, n)
    uv = alpha[:, None] * tuv0 + beta[:, None] * tuv1 + gamma[:, None] * tuv2
    uv = uv - jnp.floor(uv)  # wrap to [0,1) (triangle.cpp:195-199)
    dpdu = vm.normalize(e1)
    return n, dpdu, uv, mat_id, t_diff


def _fill_instanced(o, d, t, idx, inst: T.Instanced):
    a, nm, kind, p, ntype, mat_id = take_rows(
        idx, (inst.inv_transform, inst.normal_mat, inst.kind, inst.params,
              inst.normal_type, inst.mat_id))
    oo = vm.mat3_apply(a[:, :, :3], o) + a[:, :, 3]
    od = vm.mat3_apply(a[:, :, :3], d)
    hp = oo + t[:, None] * od

    # differentiable t via one implicit Newton step per kind
    swept_, tube_ = p[:, 0], p[:, 1]
    # box: plane of the dominant face (axis/sign detached via hp)
    half_ = jax.lax.stop_gradient(p[:, 0:3] / 2.0)
    relb = jax.lax.stop_gradient(hp) / vm._safe(half_)
    axb = jnp.argmax(jnp.abs(relb), axis=-1)
    nf = jnp.sign(jnp.take_along_axis(relb, axb[:, None], axis=-1))[:, 0:1] * jnp.eye(3)[axb]
    F_box = vm.dot(hp, nf) - vm.dot(p[:, 0:3] / 2.0, jnp.abs(nf))
    Fp_box = vm.dot(od, nf)
    # cylinder side: F = x^2 + z^2 - 1
    F_cyl = hp[:, 0] ** 2 + hp[:, 2] ** 2 - 1.0
    Fp_cyl = 2.0 * (hp[:, 0] * od[:, 0] + hp[:, 2] * od[:, 2])
    # torus: F = (|p|^2 - (R^2 + r^2))^2 + 4 R^2 (y^2 - r^2)
    s2t = vm.dot(hp, hp)
    et = s2t - swept_ * swept_ - tube_ * tube_
    F_tor = et * et + 4.0 * swept_ * swept_ * (hp[:, 1] ** 2 - tube_ * tube_)
    Fp_tor = 4.0 * et * vm.dot(hp, od) + 8.0 * swept_ * swept_ * hp[:, 1] * od[:, 1]
    # cap: plane y = p1
    F_cap = hp[:, 1] - p[:, 1]
    Fp_cap = od[:, 1]
    F = jnp.where(kind == T.INST_AABOX, F_box, 0.0)
    Fp = jnp.where(kind == T.INST_AABOX, Fp_box, 1.0)
    F = jnp.where(kind == T.INST_OPEN_CYLINDER, F_cyl, F)
    Fp = jnp.where(kind == T.INST_OPEN_CYLINDER, Fp_cyl, Fp)
    F = jnp.where(kind == T.INST_TORUS, F_tor, F)
    Fp = jnp.where(kind == T.INST_TORUS, Fp_tor, Fp)
    F = jnp.where(kind == T.INST_DISK, F_cap, F)
    Fp = jnp.where(kind == T.INST_DISK, Fp_cap, Fp)
    t_diff = _newton_t(t, F, Fp)
    hp = oo + t_diff[:, None] * od

    # Box normal: dominant axis of hit point scaled by half extents.
    half = p[:, 0:3] / 2.0
    rel = hp / vm._safe(half)
    ax = jnp.argmax(jnp.abs(rel), axis=-1)
    n_box = jnp.sign(jnp.take_along_axis(rel, ax[:, None], axis=-1)) * jnp.eye(3)[ax]

    # Cylinder normal per normal_type (fillShadeRecGenericOpenCylinder,
    # shapes/generic.cpp:3-32).
    n_side = jnp.stack([hp[:, 0], jnp.zeros_like(t), hp[:, 2]], axis=-1)
    wo_dot = vm.dot(-od, n_side)
    n_cyl = jnp.where(
        (ntype == T.NORMAL_OPEN)[:, None] & (wo_dot < 0)[:, None], -n_side, n_side
    )
    n_cyl = jnp.where((ntype == T.NORMAL_CONCAVE)[:, None], -n_side, n_cyl)
    phi_cyl = jnp.arctan2(hp[:, 2], hp[:, 0])
    uv_cyl = jnp.stack(
        [phi_cyl / vm._safe(p[:, 0]), (hp[:, 1] + 1.0) / 2.0], axis=-1
    )

    # Torus normal (computeGenericTorusNormal, shapes/generic.cpp:128-143),
    # faced toward wo.
    swept, tube = p[:, 0], p[:, 1]
    param2 = swept * swept + tube * tube
    s2 = vm.dot(hp, hp)
    n_tor = jnp.stack(
        [
            4.0 * hp[:, 0] * (s2 - param2),
            4.0 * hp[:, 1] * (s2 - param2 + 2.0 * swept * swept),
            4.0 * hp[:, 2] * (s2 - param2),
        ],
        axis=-1,
    )
    n_tor = jnp.where(vm.dot(-od, n_tor)[:, None] < 0, -n_tor, n_tor)

    n_cap = jnp.stack(
        [jnp.zeros_like(t), jnp.sign(p[:, 1]), jnp.zeros_like(t)], axis=-1
    )

    n_obj = jnp.where((kind == T.INST_AABOX)[:, None], n_box, n_side)
    n_obj = jnp.where((kind == T.INST_OPEN_CYLINDER)[:, None], n_cyl, n_obj)
    n_obj = jnp.where((kind == T.INST_TORUS)[:, None], n_tor, n_obj)
    n_obj = jnp.where((kind == T.INST_DISK)[:, None], n_cap, n_obj)

    # Push normals to world through (M^-1)^T (instanced.cpp:97-103).
    n = vm.normalize(vm.mat3_apply(nm, n_obj))
    # Box faces the ray (generic.cpp:402-406).
    box_or_cap = (kind == T.INST_AABOX) | (kind == T.INST_DISK)
    n = jnp.where(
        (box_or_cap & (vm.dot(n, d) > 0.0))[:, None], -n, n
    )
    tang, _, _ = vm.orthonormal_basis(n)
    uv = jnp.where((kind == T.INST_OPEN_CYLINDER)[:, None], uv_cyl, jnp.zeros_like(uv_cyl))
    return n, tang, uv, mat_id, t_diff


_GROUPS = (
    (T.GROUP_SPHERE, "spheres", sphere_ts, _fill_sphere),
    (T.GROUP_PLANE, "planes", plane_ts, _fill_plane),
    (T.GROUP_RECT, "rects", rect_ts, _fill_rect),
    (T.GROUP_DISK, "disks", disk_ts, _fill_disk),
    (T.GROUP_TRIANGLE, "triangles", lambda o, d, g: triangle_ts(o, d, g)[0], _fill_triangle),
    (T.GROUP_INSTANCED, "instanced", instanced_ts, _fill_instanced),
)


def _group_size(scene, name):
    return getattr(scene, name).mat_id.shape[0]


def intersect_scene(scene: T.Scene, o, d, camera_coherent: bool = False) -> Hit:
    """Closest hit across all primitive groups. Triangles go through the
    accel backend selected statically by scene.accel; analytic primitives
    (few in every scene) are always brute-forced.

    `camera_coherent=True` marks the batch as Morton-tiled camera-bounce
    rays: when the scene carries a bounce-0 binned table (T.Scene.tri_cam,
    CRAY_CAM_BINNED=1) the triangles group takes the treelet-vote binned
    traversal, whose block-synchronous cost model favors compact coherent
    tiles over incoherent bounce rays (accel/binned.py) — bounce>=1
    batches keep the fat-row BVH4 path.

    Differentiability: the SEARCH (which primitive, at what distance) is
    detached; the FILL re-derives t/normal/uv differentiably for the
    winning primitive, so interior gradients flow w.r.t. ray origins,
    directions, and scene geometry while discrete selection stays fixed."""
    n = o.shape[0]
    o_s = jax.lax.stop_gradient(o)
    d_s = jax.lax.stop_gradient(d)
    # Accel structures are part of the DETACHED search: without this,
    # differentiating the whole scene pytree (inverse rendering over all
    # leaves) drags the traversal while_loops into reverse mode, which JAX
    # rejects. Geometry gradients still flow — through the fill, which
    # re-derives t/normal/uv from scene.triangles.
    scene = scene.replace(
        tri_bvh=jax.tree.map(jax.lax.stop_gradient, scene.tri_bvh),
        sph_bvh=jax.tree.map(jax.lax.stop_gradient, scene.sph_bvh))
    best_t = jnp.full((n,), TMAX)
    best_group = jnp.full((n,), T.GROUP_NONE, jnp.int32)
    best_idx = jnp.zeros((n,), jnp.int32)

    for gid, name, ts_fn, _ in _GROUPS:
        if _group_size(scene, name) == 0:
            continue
        if gid == T.GROUP_SPHERE and scene.sph_bvh is not None:
            from craytracer_tpu.accel.bvh4_sphere import bvh4s_closest_hit

            gmin, gidx = bvh4s_closest_hit(scene.sph_bvh, o_s, d_s)
            gidx = jnp.maximum(gidx, 0)
        elif gid == T.GROUP_TRIANGLE and scene.accel == "bvh":
            from craytracer_tpu.accel.bvh import bvh_closest_hit

            gmin, gidx = bvh_closest_hit(scene.tri_bvh, o_s, d_s)
            gidx = jnp.maximum(gidx, 0)
        elif (gid == T.GROUP_TRIANGLE and camera_coherent
                and scene.tri_cam is not None):
            from craytracer_tpu.accel.binned import binned_closest_hit

            gmin, gidx = binned_closest_hit(scene.tri_cam, o_s, d_s,
                                            mxu=True,
                                            precision=jax.lax.Precision.HIGHEST)
            gidx = jnp.maximum(gidx, 0)
        elif gid == T.GROUP_TRIANGLE and scene.accel in ("bvh4", "hybrid"):
            from craytracer_tpu.accel.bvh4 import bvh4_closest_hit

            gmin, gidx = bvh4_closest_hit(scene.tri_bvh, o_s, d_s)
            gidx = jnp.maximum(gidx, 0)
        elif gid == T.GROUP_TRIANGLE and scene.accel == "binned":
            from craytracer_tpu.accel.binned import binned_closest_hit

            # the matmul form engages iff the build emitted coefficient
            # columns; HIGHEST keeps it exact float32 (no TF32)
            gmin, gidx = binned_closest_hit(scene.tri_bvh, o_s, d_s,
                                            mxu=True,
                                            precision=jax.lax.Precision.HIGHEST)
            gidx = jnp.maximum(gidx, 0)
        elif gid == T.GROUP_TRIANGLE and scene.accel == "bvh4q":
            from craytracer_tpu.accel.bvh4q import bvh4q_closest_hit

            gmin, gidx = bvh4q_closest_hit(scene.tri_bvh, o_s, d_s)
            gidx = jnp.maximum(gidx, 0)
        elif gid == T.GROUP_TRIANGLE and scene.accel == "grid":
            from craytracer_tpu.accel.grid import grid_closest_hit

            gmin, gidx = grid_closest_hit(scene.tri_bvh, o_s, d_s)
            gidx = jnp.maximum(gidx, 0)
        else:
            ts = ts_fn(o_s, d_s, jax.lax.stop_gradient(getattr(scene, name)))  # [N, M]
            gmin = jnp.min(ts, axis=1)
            gidx = jnp.argmin(ts, axis=1).astype(jnp.int32)
        better = gmin < best_t
        best_t = jnp.where(better, gmin, best_t)
        best_group = jnp.where(better, gid, best_group)
        best_idx = jnp.where(better, gidx, best_idx)

    normal = jnp.zeros_like(o).at[:, 2].set(1.0)
    dpdu = jnp.zeros_like(o).at[:, 0].set(1.0)
    uv = jnp.zeros((n, 2), o.dtype)
    mat_id = jnp.zeros((n,), jnp.int32)
    t_out = best_t  # detached search distances (misses keep TMAX)

    # Fills on MISS lanes must not see t = TMAX (~1e38): o + t*d overflows
    # to inf, and the inf intermediates turn the masked lanes' reverse-mode
    # cotangents into NaN, poisoning whole-batch gradients. Their outputs
    # are discarded by the group-select below anyway.
    t_fill = jnp.where(best_t < TMAX, best_t, 1.0)
    for gid, name, _, fill_fn in _GROUPS:
        if _group_size(scene, name) == 0:
            continue
        g_n, g_dpdu, g_uv, g_mat, g_t = fill_fn(o, d, t_fill, best_idx,
                                                getattr(scene, name))
        sel = (best_group == gid)[:, None]
        normal = jnp.where(sel, g_n, normal)
        dpdu = jnp.where(sel, g_dpdu, dpdu)
        uv = jnp.where(sel, g_uv, uv)
        mat_id = jnp.where(best_group == gid, g_mat, mat_id)
        t_out = jnp.where(best_group == gid, g_t, t_out)

    point = o + t_out[:, None] * d
    point = jnp.where((best_t < TMAX)[:, None], point, 0.0)
    return Hit(t=t_out, group=best_group, prim=best_idx, point=point,
               normal=normal, dpdu=dpdu, uv=uv, mat_id=mat_id)


def shadow_distance(scene: T.Scene, o, d, max_dist=None) -> jnp.ndarray:
    """Min hit distance for shadow rays (no attributes). The caller compares
    against the light distance (shadowIntersectTest early-out semantics,
    intersect.h:443-545, folded into one reduction). With a BVH, the
    triangle pass is a true any-hit with early termination."""
    n = o.shape[0]
    # Shadow visibility is non-differentiable by design (the reference
    # treats it as a boolean, trace.h:478); detach EVERYTHING so whole-
    # scene reverse mode never differentiates the traversal while_loops
    # and the geom-axis pmin (which has no differentiation rule).
    scene = jax.tree.map(jax.lax.stop_gradient, scene)
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    best_t = jnp.full((n,), TMAX)
    for gid, name, ts_fn, _ in _GROUPS:
        if _group_size(scene, name) == 0:
            continue
        if gid == T.GROUP_SPHERE and scene.sph_bvh is not None:
            from craytracer_tpu.accel.bvh4_sphere import bvh4s_any_hit

            md = max_dist if max_dist is not None else jnp.full((n,), TMAX)
            best_t = jnp.minimum(best_t, bvh4s_any_hit(scene.sph_bvh, o, d, md))
        elif gid == T.GROUP_TRIANGLE and scene.accel == "bvh":
            from craytracer_tpu.accel.bvh import bvh_any_hit

            md = max_dist if max_dist is not None else jnp.full((n,), TMAX)
            best_t = jnp.minimum(best_t, bvh_any_hit(scene.tri_bvh, o, d, md))
        elif gid == T.GROUP_TRIANGLE and scene.accel == "bvh4":
            from craytracer_tpu.accel.bvh4 import bvh4_any_hit

            md = max_dist if max_dist is not None else jnp.full((n,), TMAX)
            best_t = jnp.minimum(best_t, bvh4_any_hit(scene.tri_bvh, o, d, md))
        elif gid == T.GROUP_TRIANGLE and scene.accel in ("binned", "hybrid"):
            from craytracer_tpu.accel.binned import binned_any_hit
            from craytracer_tpu.ops.raysort import ray_key

            tb = scene.tri_shadow if scene.accel == "hybrid" else scene.tri_bvh
            md = max_dist if max_dist is not None else jnp.full((n,), TMAX)
            # Coherence re-sort before the block-synchronous traversal:
            # later-bounce shadow origins arrive shuffled, and a binned
            # block's cost is its UNION of needed treelets
            # (accel/binned.py docstring). One argsort + gathers; results
            # scatter back to lane order.
            perm = jnp.argsort(ray_key(o, d))
            t_s = binned_any_hit(tb, jnp.take(o, perm, axis=0),
                                 jnp.take(d, perm, axis=0),
                                 jnp.take(md, perm), mxu=True,
                                 precision=jax.lax.Precision.HIGHEST)
            best_t = jnp.minimum(
                best_t, jnp.zeros((n,), t_s.dtype).at[perm].set(t_s))
        elif gid == T.GROUP_TRIANGLE and scene.accel == "bvh4q":
            from craytracer_tpu.accel.bvh4q import bvh4q_any_hit

            md = max_dist if max_dist is not None else jnp.full((n,), TMAX)
            best_t = jnp.minimum(best_t, bvh4q_any_hit(scene.tri_bvh, o, d, md))
        elif gid == T.GROUP_TRIANGLE and scene.accel == "grid":
            from craytracer_tpu.accel.grid import grid_any_hit

            md = max_dist if max_dist is not None else jnp.full((n,), TMAX)
            best_t = jnp.minimum(best_t, grid_any_hit(scene.tri_bvh, o, d, md))
        else:
            ts = ts_fn(o, d, getattr(scene, name))
            best_t = jnp.minimum(best_t, jnp.min(ts, axis=1))
    return best_t
