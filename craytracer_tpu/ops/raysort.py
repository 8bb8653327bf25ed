"""Ray reordering for traversal coherence.

The reference traverses rays one CPU thread at a time, so ray order is
irrelevant there (intersect.h:61-194 walks each ray independently). A
block-synchronous traversal (accel/binned.py) pays, per block of rays,
the union of the nodes its rays need. Secondary wavefront rays arrive
shuffled (diffuse bounces, NEE toward scattered lights); sorting them so
that each block holds spatially/directionally coherent rays shrinks that
union — the classic wavefront-tracing ordering step (Garanzha & Loop
style key = quantized origin Morton + direction octant).

Keys are jit-safe: computed from batch statistics (origin min/max); the
caller argsorts them and scatters results back to ray order.
"""

from __future__ import annotations

import jax.numpy as jnp


def _part1by2(x):
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3(q):
    """[N,3] uint32 (each < 2^10) -> [N] interleaved 30-bit Morton code."""
    return (_part1by2(q[:, 0])
            | (_part1by2(q[:, 1]) << 1)
            | (_part1by2(q[:, 2]) << 2))


def ray_key(o, d, pos_bits: int = 6, dir_major: bool = False):
    """Coherence sort key per ray.

    pos_bits quantization of origin inside the batch's own AABB (adapts
    to whatever surface the bounce scattered from), Morton-interleaved;
    direction octant as the 3-bit tiebreak. dir_major flips the nesting
    (octant first) — better when the scene is small and direction
    divergence dominates traversal order.
    """
    # ESCAPE rays (retired wavefront lanes parked at |o| ~ 3e18,
    # integrator/wavefront.py) must not stretch the batch AABB: quantize
    # against the box of REAL origins only; escapes all land in the top
    # cell together (they retire on their first round anyway).
    real = (jnp.abs(o) < 1.0e17).all(axis=1)
    big = jnp.where(real[:, None], o, -jnp.inf)
    small = jnp.where(real[:, None], o, jnp.inf)
    lo = jnp.min(small, axis=0)
    hi = jnp.max(big, axis=0)
    lo = jnp.where(jnp.isfinite(lo), lo, 0.0)
    hi = jnp.where(jnp.isfinite(hi), hi, 1.0)
    scale = (1 << pos_bits) / jnp.maximum(hi - lo, 1e-6)
    q = jnp.clip(((jnp.clip(o, lo, hi) - lo) * scale).astype(jnp.uint32), 0,
                 (1 << pos_bits) - 1)
    # quantized axes promoted to the Morton bit positions: with
    # pos_bits<10 shift up so the most significant quantization bit sits
    # at Morton bit 3*pos_bits (keeps keys dense, order unchanged)
    code = morton3(q)
    octant = ((d[:, 0] < 0).astype(jnp.uint32)
              | ((d[:, 1] < 0).astype(jnp.uint32) << 1)
              | ((d[:, 2] < 0).astype(jnp.uint32) << 2))
    if dir_major:
        return (octant << (3 * pos_bits)) | code
    return (code << 3) | octant
