"""Counter-based stateless RNG for the wavefront loop.

The reference uses a global multijittered sample table + per-thread `Sampler`
cursors and raw `rand()` calls (sampling.cpp:514-603, trace.h:371,516) — a
stateful, data-race-prone design. The replacement here is a pure
counter-based generator: every uniform is a hash of
(seed, pixel_id, spp_index, bounce, dimension), so any lane on any shard of
any host can regenerate its stream independently — no state, no
synchronization, reproducible under resharding and checkpoint/resume.

The mixer is the murmur3/splitmix-style 32-bit finalizer (full avalanche),
applied over a Weyl-sequence combination of the counters. That is the
standard quality bar for MC rendering RNGs (cf. PCG/wang-hash usage in GPU
path tracers).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_GOLDEN = np.uint32(0x9E3779B9)  # 2^32 / phi, Weyl increment
_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)


def hash_u32(x):
    """Murmur3 fmix32 finalizer over uint32 arrays."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * _M1
    x = x ^ (x >> 13)
    x = x * _M2
    x = x ^ (x >> 16)
    return x


def _combine(seed, pixel_id, spp_index, bounce, dim):
    # pixel and spp are hashed in separate rounds before combining: a linear
    # fold (pixel + GOLDEN*spp) aliases whenever pixel2-pixel1 == GOLDEN*k
    # (mod 2^32), replaying entire sample streams between those lanes.
    h = hash_u32(jnp.asarray(pixel_id, jnp.uint32))
    h = hash_u32(h ^ hash_u32(jnp.uint32(spp_index)))
    h = hash_u32(h ^ (jnp.uint32(seed) + _GOLDEN * jnp.uint32(bounce)))
    return hash_u32(h + _GOLDEN * jnp.asarray(dim, jnp.uint32))


def uniforms(seed, pixel_id, spp_index, bounce, n_dims, dim0: int = 0):
    """[N, n_dims] uniforms in [0, 1) for lanes `pixel_id` at a given
    (sample-index, bounce). `dim0` offsets the dimension counter so separate
    call sites consume disjoint dimensions."""
    pixel_id = jnp.asarray(pixel_id, jnp.uint32)
    dims = jnp.arange(dim0, dim0 + n_dims, dtype=jnp.uint32)
    # spp_index may be per-lane (spp-batched dispatch): align its axis with
    # pixel_id so the hash broadcasts [N, n_dims], not [N, N]
    spp_index = jnp.asarray(spp_index, jnp.uint32)
    if spp_index.ndim == pixel_id.ndim and spp_index.ndim > 0:
        spp_index = spp_index[..., None]
    bits = _combine(seed, pixel_id[..., None], spp_index, bounce, dims)
    # Take the top 24 bits -> uniform in [0, 1) exactly representable in f32.
    return (bits >> np.uint32(8)).astype(jnp.float32) * np.float32(1.0 / (1 << 24))
