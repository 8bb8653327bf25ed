"""Ray-coherence sort keys (ops/raysort.py), used to order shadow rays
for the block-synchronous binned any-hit traversal. The reference has no
analog (single-ray CPU traversal, intersect.h)."""

import jax.numpy as jnp
import numpy as np

from craytracer_tpu.ops.raysort import morton3, ray_key


def test_morton3_known_values():
    q = jnp.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                   [1, 1, 1], [2, 0, 0], [3, 3, 3]], jnp.uint32)
    out = np.asarray(morton3(q))
    assert out.tolist() == [0, 1, 2, 4, 7, 8, 63]


def test_key_octant_tiebreak():
    o = jnp.zeros((8, 3))
    d = jnp.array([[sx, sy, sz] for sz in (1.0, -1.0)
                   for sy in (1.0, -1.0) for sx in (1.0, -1.0)])
    k = np.asarray(ray_key(o, d))
    # same origin -> keys differ only in the 3 octant bits, all distinct
    assert len(set(k.tolist())) == 8
    assert (k - k.min() < 8).all()


def test_key_groups_spatial_clusters():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 3)) * 0.01
    b = rng.normal(size=(64, 3)) * 0.01 + 10.0
    o = jnp.asarray(np.concatenate([a, b]), jnp.float32)
    d = jnp.asarray(rng.normal(size=(128, 3)), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    key = np.asarray(ray_key(o, d))
    order = np.argsort(key, kind="stable")
    halves = (order < 64)
    # a perfect split: one cluster occupies each half of the sorted order
    assert halves[:64].all() != halves[64:].any()
