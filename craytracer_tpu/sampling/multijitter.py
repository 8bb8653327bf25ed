"""Multijittered sample tables (genMultijitteredSamples, sampling.cpp:260-352).

The reference pre-generates `num_sets` tables of `num_samples` multijittered
2-D points and walks them per pixel with permuted set sequences. The
default here is the counter RNG; this module provides

* `multijittered_table(...)`: the reference's table generator (host-side,
  for parity experiments and spectral comparisons), and
* `stratified_jitter(...)`: a stateless per-(pixel, spp) stratified film
  jitter — the variance-reduction benefit of the MJ tables in counter form:
  sample s of pixel p lands in stratum (s mod k^2) of a k x k grid with a
  per-pixel permutation, jittered within the stratum.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from craytracer_tpu.sampling.rng import hash_u32, uniforms


def multijittered_table(num_samples: int, num_sets: int, seed: int = 0) -> np.ndarray:
    """[num_sets, num_samples, 2] multijittered points: stratified on both
    the n x n grid and the n^2 1-D shuffles (canonical MJ construction)."""
    n = int(np.sqrt(num_samples))
    assert n * n == num_samples, "num_samples must be a perfect square"
    rng = np.random.default_rng(seed)
    out = np.empty((num_sets, num_samples, 2), np.float32)
    for s in range(num_sets):
        pts = np.empty((n, n, 2), np.float64)
        for i in range(n):
            for j in range(n):
                pts[i, j, 0] = (i + (j + rng.random()) / n) / n
                pts[i, j, 1] = (j + (i + rng.random()) / n) / n
        # canonical MJ shuffle: x sub-offsets permute within each row
        # (coarse x stays i), y sub-offsets within each column
        for i in range(n):
            pts[i, rng.permutation(n), 0] = pts[i, :, 0].copy()
        for j in range(n):
            pts[rng.permutation(n), j, 1] = pts[:, j, 1].copy()
        out[s] = pts.reshape(num_samples, 2)
    return out


def stratified_jitter(seed, pixel_ids, spp_index, strata: int = 4):
    """[N, 2] film jitter for sample `spp_index`: stratum index is a
    per-pixel permutation of (spp_index mod strata^2), jitter inside the
    stratum comes from the counter RNG. Falls back to pure random beyond
    strata^2 samples per pixel cycle."""
    k2 = strata * strata
    u = uniforms(seed, pixel_ids, spp_index, 0x7FFF, 2, 0)
    # per-pixel rotation of the stratum sequence
    rot = hash_u32(jnp.asarray(pixel_ids, jnp.uint32) ^ jnp.uint32(seed * 977)) % k2
    stratum = (jnp.uint32(spp_index) + rot) % k2
    sx = (stratum % strata).astype(jnp.float32)
    sy = (stratum // strata).astype(jnp.float32)
    inv = 1.0 / strata
    return jnp.stack([(sx + u[:, 0]) * inv, (sy + u[:, 1]) * inv], axis=-1)
