"""Branchless polynomial root solvers for batched ray-primitive tests.

Replaces the reference's scalar `solveQuadric`/`solveCubic`/`solveQuartic`
(`util/math.cpp:156-340`, used by the torus at `shapes/generic.cpp:156-222`)
with mask-based versions that evaluate a fixed op sequence for every lane —
the batched shape: no data-dependent branching, all lanes run the same
program, invalid roots are carried as +TMAX sentinels.

Quartic strategy: Ferrari's method through the resolvent cubic in f32,
followed by Newton polish iterations on the original quartic to recover the
precision the reference gets from doubles.
"""

from __future__ import annotations

import jax.numpy as jnp

from craytracer_tpu.constants import TMAX


def solve_quadratic(a, b, c):
    """Roots of a x^2 + b x + c. Returns (has_roots, t0, t1) with t0 <= t1.

    Uses the numerically-stable form q = -(b + sign(b) sqrt(disc))/2.
    Invalid lanes return TMAX for both roots.
    """
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.where(b >= 0.0, sq, -sq))
    safe_a = jnp.where(a == 0.0, 1.0, a)
    safe_q = jnp.where(q == 0.0, 1.0, q)
    r0 = q / safe_a
    r1 = c / safe_q
    # Degenerate (linear) lanes: a == 0 -> single root -c/b.
    lin = a == 0.0
    bl = jnp.where(b == 0.0, 1.0, b)
    r_lin = -c / bl
    r0 = jnp.where(lin, r_lin, r0)
    r1 = jnp.where(lin, r_lin, r1)
    t0 = jnp.minimum(r0, r1)
    t1 = jnp.maximum(r0, r1)
    t0 = jnp.where(ok, t0, TMAX)
    t1 = jnp.where(ok, t1, TMAX)
    return ok, t0, t1


def cubic_one_root(a, b, c, d):
    """One real root of a x^3 + b x^2 + c x + d (a != 0), branchless.

    Uses the depressed-cubic trigonometric/Cardano split. Only used to seed
    Ferrari's quartic, so moderate accuracy is fine (roots are polished)."""
    inv_a = 1.0 / jnp.where(a == 0.0, 1.0, a)
    B = b * inv_a
    C = c * inv_a
    D = d * inv_a
    # Depress: x = y - B/3
    p = C - B * B / 3.0
    q = 2.0 * B * B * B / 27.0 - B * C / 3.0 + D
    disc = (q * q) / 4.0 + (p * p * p) / 27.0

    # Cardano branch (disc >= 0): one real root.
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    y_card = u + v

    # Trig branch (disc < 0): three real roots; take k = 0.
    pm = jnp.minimum(p, -1e-12)  # p < 0 guaranteed when disc < 0
    m = 2.0 * jnp.sqrt(-pm / 3.0)
    arg = jnp.clip(3.0 * q / (pm * m), -1.0, 1.0)
    y_trig = m * jnp.cos(jnp.arccos(arg) / 3.0)

    y = jnp.where(disc >= 0.0, y_card, y_trig)
    return y - B / 3.0


def solve_quartic(b, c, d, e, newton_iters: int = 2):
    """Real roots of x^4 + b x^3 + c x^2 + d x + e (monic).

    Returns (roots[..., 4], valid[..., 4]); invalid entries hold TMAX.
    Ferrari: depress with x = y - b/4, resolvent cubic for m, then two
    quadratics. `newton_iters` Newton steps polish each root against the
    original quartic to recover f32 accuracy (the reference relies on doubles
    in util/math.cpp:251-340)."""
    # Depressed quartic y^4 + p y^2 + q y + r
    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b2 * b / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0

    # Resolvent cubic: m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0
    m = cubic_one_root(jnp.ones_like(p), p, p * p / 4.0 - r, -q * q / 8.0)
    m = jnp.maximum(m, 0.0)

    # Biquadratic case (q ~ 0): y^2 = (-p +- sqrt(p^2-4r))/2
    biquad = jnp.abs(q) < 1e-12
    disc_bq = p * p - 4.0 * r
    sq_bq = jnp.sqrt(jnp.maximum(disc_bq, 0.0))
    y2a = (-p + sq_bq) / 2.0
    y2b = (-p - sq_bq) / 2.0

    sqrt2m = jnp.sqrt(jnp.maximum(2.0 * m, 0.0))
    safe_s = jnp.where(sqrt2m == 0.0, 1.0, sqrt2m)
    # y^2 +- sqrt(2m) y + (p/2 + m -+ q/(2 sqrt(2m))) = 0
    qa_c = p / 2.0 + m - q / (2.0 * safe_s)
    qb_c = p / 2.0 + m + q / (2.0 * safe_s)

    ok1, r0, r1 = solve_quadratic(jnp.ones_like(p), sqrt2m, qa_c)
    ok2, r2, r3 = solve_quadratic(jnp.ones_like(p), -sqrt2m, qb_c)

    # Biquadratic roots
    okb1 = biquad & (y2a >= 0.0)
    okb2 = biquad & (y2b >= 0.0)
    sb1 = jnp.sqrt(jnp.maximum(y2a, 0.0))
    sb2 = jnp.sqrt(jnp.maximum(y2b, 0.0))
    r0 = jnp.where(biquad, jnp.where(okb1, sb1, TMAX), r0)
    r1 = jnp.where(biquad, jnp.where(okb1, -sb1, TMAX), r1)
    r2 = jnp.where(biquad, jnp.where(okb2, sb2, TMAX), r2)
    r3 = jnp.where(biquad, jnp.where(okb2, -sb2, TMAX), r3)
    ok1 = jnp.where(biquad, okb1, ok1)
    ok2 = jnp.where(biquad, okb2, ok2)

    roots = jnp.stack([r0, r1, r2, r3], axis=-1)
    valid = jnp.stack([ok1, ok1, ok2, ok2], axis=-1)
    roots = roots - b[..., None] / 4.0  # un-depress
    roots = jnp.where(valid, roots, TMAX)

    # Newton polish on the original quartic.
    bb, cc, dd, ee = (x[..., None] for x in (b, c, d, e))
    for _ in range(newton_iters):
        x = roots
        f = (((x + bb) * x + cc) * x + dd) * x + ee
        fp = ((4.0 * x + 3.0 * bb) * x + 2.0 * cc) * x + dd
        step = f / jnp.where(jnp.abs(fp) < 1e-12, 1e-12, fp)
        roots = jnp.where(valid & (roots < TMAX), x - step, roots)

    return roots, valid
