"""Batched vector math on `[..., 3]` arrays.

The reference's scalar vec3/mat libraries (`util/vec.h`, `util/mat.h`,
`util/math.h`) dissolve into jnp ops over SoA batches; everything here is
shape-polymorphic over leading batch dims, branchless, and NaN-safe so it can
sit inside `jit`/`vmap`/`grad` without data-dependent control flow.
"""

from __future__ import annotations

import jax.numpy as jnp

from craytracer_tpu.constants import INV_PI, PI, TWO_PI


def dot(a, b, keepdims: bool = False):
    # Component-expanded rather than jnp.sum(axis=-1): a minor-dim reduce
    # can compile to its own reduce-fusion kernel with a device-memory
    # round trip, while the expanded form is plain elementwise math that
    # XLA fuses into neighboring producers/consumers.
    if a.shape[-1] == 3 or b.shape[-1] == 3:
        r = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
             + a[..., 2] * b[..., 2])
    else:
        r = jnp.sum(a * b, axis=-1)
    return r[..., None] if keepdims else r


def cross(a, b):
    return jnp.cross(a, b)


def max3(a, keepdims: bool = False):
    """max over a size-3 trailing axis, expanded (see dot): no reduce op."""
    r = jnp.maximum(jnp.maximum(a[..., 0], a[..., 1]), a[..., 2])
    return r[..., None] if keepdims else r


def min3(a, keepdims: bool = False):
    r = jnp.minimum(jnp.minimum(a[..., 0], a[..., 1]), a[..., 2])
    return r[..., None] if keepdims else r


def length(a, keepdims: bool = False):
    # clamp above zero: sqrt has an infinite gradient at 0, which poisons
    # autodiff through masked-out lanes (0 * inf = NaN)
    return jnp.sqrt(jnp.maximum(dot(a, a, keepdims=keepdims), 1e-20))


def length_sq(a, keepdims: bool = False):
    return dot(a, a, keepdims=keepdims)


def normalize(a, eps: float = 1e-20):
    """Safe normalize: returns `a/|a|`, or zeros for (near-)zero vectors."""
    n2 = dot(a, a, keepdims=True)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)
    return a * inv


def reflect(wo, n):
    """Mirror direction of `wo` about normal `n` (both pointing away from
    the surface on the same side). Matches `util/ray.cpp` reflect semantics."""
    return 2.0 * dot(wo, n, keepdims=True) * n - wo


def refract(wi, n, eta):
    """PBRT-style refraction (reference `reflection.cpp:26-49` refract).

    wi points away from the surface, n is the normal on wi's side, eta is
    incident_ior / transmitted_ior. Returns (ok_mask, wt).
    """
    cos_theta_i = dot(n, wi, keepdims=True)
    sin2_theta_i = jnp.maximum(0.0, 1.0 - cos_theta_i * cos_theta_i)
    eta = jnp.asarray(eta)
    if eta.ndim < n.ndim:
        eta = eta[..., None]
    sin2_theta_t = eta * eta * sin2_theta_i
    ok = (sin2_theta_t < 1.0)[..., 0]
    cos_theta_t = jnp.sqrt(jnp.maximum(1.0 - sin2_theta_t, 1e-12))
    wt = -eta * wi + (eta * cos_theta_i - cos_theta_t) * n
    return ok, wt


def orthonormal_basis(n):
    """Build a (t, b, n) frame from unit normals, branchlessly (Duff et al.).

    Replaces the reference's `computeLocalBasis` (trace.h:132-146) when no
    surface dpdu is available.
    """
    s = jnp.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = jnp.stack(
        [1.0 + s[..., 0] * n[..., 0] * n[..., 0] * a[..., 0],
         s[..., 0] * b[..., 0],
         -s[..., 0] * n[..., 0]],
        axis=-1,
    )
    bt = jnp.stack(
        [b[..., 0],
         s[..., 0] + n[..., 1] * n[..., 1] * a[..., 0],
         -n[..., 1]],
        axis=-1,
    )
    return t, bt, n


def make_shading_frame(normal, dpdu):
    """Gram-Schmidt the surface tangent against the normal, mirroring
    `computeLocalBasis` (trace.h:132-146): tangent = normalize(dpdu - (n.dpdu)n),
    binormal = n x tangent. Falls back to a constructed basis when dpdu is
    degenerate."""
    t = dpdu - dot(normal, dpdu, keepdims=True) * normal
    t_len2 = dot(t, t, keepdims=True)
    ft, fb, _ = orthonormal_basis(normal)
    t = jnp.where(t_len2 > 1e-12, normalize(t), ft)
    b = normalize(cross(normal, t))
    return t, b, normal


def to_local(v, t, b, n):
    """World -> shading-local: returns (v.t, v.b, v.n)."""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def to_world(v, t, b, n):
    """Shading-local -> world (orthoNormalTransform, util/math.h:55)."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def mat3_apply(m, v):
    """M v for 3x3 matrices m [..., 3, 3] and vectors v [..., 3]
    (broadcasting), written as explicit multiply-adds: exact float32,
    where a matmul may run at reduced (TF32) precision on a GPU."""
    return (m[..., :, 0] * v[..., None, 0] + m[..., :, 1] * v[..., None, 1]
            + m[..., :, 2] * v[..., None, 2])


# ---------------------------------------------------------------------------
# Shading-frame trig on local-space directions (z = normal), matching
# util/math.h:13-40.

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def sin2_theta(w):
    return jnp.maximum(0.0, 1.0 - cos2_theta(w))


def sin_theta(w):
    # gradient-safe sqrt (see length)
    return jnp.sqrt(jnp.maximum(sin2_theta(w), 1e-16))


def tan_theta(w):
    # cos clamp at 1e-3 (grazing cutoff ~0.06 deg): keeps 1/cos^2 and its
    # gradient far from f32 overflow (inf gradients poison masked lanes)
    c = cos_theta(w)
    c = jnp.where(jnp.abs(c) < 1e-3, jnp.where(c < 0, -1e-3, 1e-3), c)
    return sin_theta(w) / c


def tan2_theta(w):
    return sin2_theta(w) / jnp.maximum(cos2_theta(w), 1e-6)


def cos_phi(w):
    # s < 1e-6, not == 0: sin_theta's sqrt floor returns ~1e-8 at the
    # pole, so an equality guard never fires there and BOTH cos_phi and
    # sin_phi come out ~0 — cos^2+sin^2 = 0 instead of 1, which fed
    # sqrt(0) in the anisotropic-alpha interpolation and NaN'd reverse
    # mode w.r.t. roughness (d sqrt(0) = inf). pbrt's pole convention.
    s = sin_theta(w)
    return jnp.where(s < 1e-6, 1.0, jnp.clip(w[..., 0] / _safe(s), -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    return jnp.where(s < 1e-6, 0.0, jnp.clip(w[..., 1] / _safe(s), -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def _safe(x, eps: float = 1e-12):
    """Divide-guard: replace ~0 with +-eps, keeping sign.

    eps must satisfy 1/eps^2 < f32 max: reverse-mode d(1/x)/dx = -1/x^2,
    and at the old 1e-20 guard that overflowed to -inf, so every masked
    lane's 0-cotangent became 0 * inf = NaN and poisoned whole-batch
    gradients through the fill/BSDF where-chains. 1/x stays ~1e12, far
    beyond TMAX, so guarded misses are still rejected."""
    return jnp.where(jnp.abs(x) < eps, jnp.where(x < 0, -eps, eps), x)


# ---------------------------------------------------------------------------
# Spherical <-> cartesian <-> UV (util/math.h:91-107). The y axis is "up",
# theta in [0, pi] from +y, phi = atan2(x, z) in [-pi, pi] -> remapped to [0, 2pi].

def spherical_direction(sin_t, cos_t, phi):
    """Local-frame direction from spherical angles (z-up, as microfacet code)."""
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def cartesian_to_spherical(d):
    """World direction -> (theta, phi), the reference's exact convention
    (cartesianToSpherical, util/math.h:95-101): phi = atan2(z, x) + pi
    (so phi in [0, 2pi]), theta = acos(y). The azimuth ORIGIN and WINDING
    are image-visible in env-map orientation — anchored by
    tests/goldens/golden_textured.is."""
    # strictly-interior clip: arccos'(+-1) = inf while clip' = 0 there, and
    # inf * 0 = NaN poisons reverse-mode batches (see ops/intersect.py)
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0 + 1e-6, 1.0 - 1e-6))
    phi = jnp.arctan2(d[..., 2], d[..., 0]) + PI
    return theta, phi


def spherical_to_uv(theta, phi):
    """sphericalToUV (util/math.h:103-107): v = 1 - theta/pi. The flip
    cancels getTexColor's own v flip (bsdf/texture.py nearest_texel_xy),
    so the NET env mapping puts image row 0 at theta ~ 0 (the zenith)."""
    return phi * (1.0 / TWO_PI), 1.0 - theta * INV_PI


def rotate_y(angle):
    """3x3 rotation about y (mat3_rotate_y, util/mat.h), used by env-light
    transforms (buildscene.h:516)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=jnp.float32)


def euler_to_mat3(angles):
    """Euler XYZ -> rotation matrix (eulerAngToMat4, util/mat.h), applied as
    Rz(z) @ Ry(y) @ Rx(x) like the reference's column-major composition."""
    import numpy as np

    x, y, z = [float(a) for a in angles]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)


def deg_to_rad(d):
    return d * (PI / 180.0)
