"""Table-driven samplers: the reference's full sample-set family.

sampling.cpp generates three 2-D point-set kinds (genRegularSamples
:169-198, genMultijitteredSamples :260-352, genHammersleySamples
:326-352), stores them in a global table of `num_sets` sets, assigns
each pixel a random set and walks per-dimension permutations of the sets
(createGlobalSampleObject :514-544, Sampler_getSample :564-603).

Batched shape: the table is a static [num_sets, num_samples, 2] array
baked on the host; the per-pixel/per-dimension set choice is a stateless
hash (the counter-RNG analog of the reference's rand()-filled
`random_sets` and `permutation_arrays`), so any lane on any shard can
draw its table sample with one fused gather:

    set_id = hash(pixel, dim, seed) % num_sets
    u2     = table[set_id, spp_index % num_samples]

`SampleTable` is a pytree; `render_sample(..., sampler=table)` switches
the camera-jitter dimension to table sampling (the dimension the
reference's stratification visibly helps: pixel antialiasing and the
first bounce). Other path dimensions keep the counter RNG — they are
decorrelated across bounces where table reuse would alias (the
reference re-uses the same 2-D points across dimensions whenever its 83
sets collide along a path, a known weakness, not a behavior to copy).
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax.numpy as jnp
import numpy as np

from craytracer_tpu.sampling.multijitter import multijittered_table
from craytracer_tpu.sampling.rng import hash_u32


def regular_table(num_samples: int, num_sets: int) -> np.ndarray:
    """genRegularSamples (sampling.cpp:169-198): the n x n lattice of
    stratum centers, identical in every set."""
    n = int(np.sqrt(num_samples))
    assert n * n == num_samples, "num_samples must be a perfect square"
    ij = (np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                   axis=-1).reshape(-1, 2) + 0.5) / n
    pts = ij[:, ::-1].astype(np.float32)  # (x fast, y slow) like the loop
    return np.broadcast_to(pts, (num_sets, num_samples, 2)).copy()


def _radical_inverse_base2(i: np.ndarray) -> np.ndarray:
    bits = i.astype(np.uint32)
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return bits.astype(np.float64) * 2.0 ** -32


def hammersley_table(num_samples: int, num_sets: int,
                     shuffle_seed: int = 0) -> np.ndarray:
    """genHammersleySamples (sampling.cpp:326-352): (i/N, phi2(i)); the
    reference shuffles sample order per set (shuffleSamples), which keeps
    the point SET identical but decorrelates the per-spp walk order."""
    i = np.arange(num_samples)
    pts = np.stack([i / num_samples, _radical_inverse_base2(i)],
                   axis=-1).astype(np.float32)
    rng = np.random.default_rng(shuffle_seed)
    out = np.empty((num_sets, num_samples, 2), np.float32)
    for s in range(num_sets):
        out[s] = pts[rng.permutation(num_samples)]
    return out


@struct.dataclass
class SampleTable:
    """Pytree wrapper for a device-resident sample-set table."""

    points: jnp.ndarray  # [num_sets, num_samples, 2] f32
    kind: str = struct.field(pytree_node=False, default="multijittered")

    @property
    def num_sets(self) -> int:
        return self.points.shape[0]

    @property
    def num_samples(self) -> int:
        return self.points.shape[1]


def make_sample_table(kind: str, num_samples: int, num_sets: int = 83,
                      seed: int = 0) -> SampleTable:
    """kind in {regular, multijittered, hammersley} — the reference's three
    generators, selected by its num_samples/num_sample_sets config."""
    if kind == "regular":
        pts = regular_table(num_samples, num_sets)
    elif kind == "multijittered":
        pts = multijittered_table(num_samples, num_sets, seed)
    elif kind == "hammersley":
        pts = hammersley_table(num_samples, num_sets, seed)
    else:
        raise ValueError(f"unknown sample-table kind {kind!r}")
    return SampleTable(points=jnp.asarray(pts), kind=kind)


def table_sample(table: SampleTable, seed, pixel_ids, spp_index, dim: int):
    """[N, 2] table sample for (pixel, spp, dim): per-(pixel, dim) set pick
    via the stateless hash standing in for the reference's random_sets +
    permutation_arrays (sampling.cpp:514-603), one fused row gather."""
    from craytracer_tpu.ops.gather import take_rows

    pix = jnp.asarray(pixel_ids, jnp.uint32)
    set_id = hash_u32(pix ^ (jnp.uint32(seed) * np.uint32(0x9E3779B9))
                      ^ (jnp.uint32(dim) * np.uint32(0x85EBCA6B)))
    set_id = (set_id % jnp.uint32(table.num_sets)).astype(jnp.int32)
    s_idx = jnp.uint32(spp_index) % jnp.uint32(table.num_samples)
    flat = table.points.reshape(-1, 2)
    rows = set_id * table.num_samples + s_idx.astype(jnp.int32)
    (u2,) = take_rows(rows, (flat,))
    return u2
