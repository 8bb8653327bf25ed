"""CPU tests of what surrounds the GPU path: the megakernel wrapper's lane
blocks and padding, its lowering to Triton for CUDA, the one path
decision, the compile-cache placement, the gather, the matmul-free 3x3
transforms and the in-repo pytree dataclass."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from craytracer_tpu.io.scenefile import load_scene_file

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _scene(name, size=16):
    scene, cam, film = load_scene_file(os.path.join(SCENES, name))
    return scene, cam, film.replace(width=size, height=size)


@pytest.mark.parametrize("n", [1, 5, 16, 100, 257, 4096, 262144])
def test_lane_block_is_power_of_two_and_covers_n(n):
    from craytracer_tpu.integrator.pallas_shade import PASS_BLOCK, lane_block

    blk = lane_block(n)
    assert blk & (blk - 1) == 0 and 16 <= blk <= PASS_BLOCK
    padded = n + (-n) % blk
    assert padded % blk == 0 and padded - n < blk
    # small passes do not trace a full default block of padding
    assert blk <= max(16, 2 * n)


def test_lane_block_rejects_non_power_of_two():
    from craytracer_tpu.integrator.pallas_shade import lane_block

    with pytest.raises(ValueError):
        lane_block(100, block=96)


@pytest.mark.parametrize("n", [1, 37])
def test_fused_pass_pads_and_slices_lanes(n):
    """Lane counts that are not a block multiple: pads are sliced away and
    every real lane matches the XLA wavefront."""
    from craytracer_tpu.camera import generate_rays
    from craytracer_tpu.integrator.pallas_shade import fused_pass
    from craytracer_tpu.integrator.wavefront import CAMERA_BOUNCE, trace_paths
    from craytracer_tpu.sampling import uniforms

    scene, cam, film = _scene("parity_cornell.txt")
    pix = jnp.arange(100, 100 + n, dtype=jnp.int32)
    o, d = generate_rays(cam, film, pix,
                         uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 0))
    L, good, m = fused_pass(scene, o, d, pix, 0, 0, 3, interpret=True)
    assert L.shape == (n, 3) and good.shape == (n,)
    assert m["bounce_live"].shape == (4,)
    assert int(m["bounce_live"][0]) == n  # pads never count
    L_ref, good_ref, m_ref = trace_paths(scene, o, d, 0, pix, 0, 3,
                                         with_metrics=True)
    np.testing.assert_allclose(np.asarray(L), np.asarray(L_ref),
                               rtol=2e-5, atol=2e-5)
    assert int(m["rays"]) == int(m_ref["rays"])


@pytest.mark.parametrize("raygen", [None, "strat"])
def test_fused_pass_lowers_to_triton_for_cuda(raygen):
    """The kernel lowers through Pallas' Triton route for the CUDA
    platform (every primitive it uses has a Triton lowering) — checked on
    the CPU without a card; compiling the Triton IR happens on the card."""
    from craytracer_tpu.integrator.pallas_shade import fused_pass

    scene, cam, film = _scene("parity_mix.txt")
    pix = jnp.arange(256, dtype=jnp.int32)
    if raygen is None:
        o = jnp.zeros((256, 3), jnp.float32)
        d = jnp.ones((256, 3), jnp.float32) / np.sqrt(3.0)
        fn = jax.jit(lambda s, o, d, p: fused_pass(s, o, d, p, 0, 0, 4))
        traced = fn.trace(scene, o, d, pix)
    else:
        fn = jax.jit(lambda s, c, p: fused_pass(
            s, None, None, p, 0, 0, 4, raygen=raygen, camera=c, film=film,
            width=int(film.width)))
        traced = fn.trace(scene, cam, pix)
    text = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text


def test_production_fast_shade_is_false_on_cpu():
    from craytracer_tpu.integrator.pallas_shade import (fast_shade_mode,
                                                        production_fast_shade)

    scene, cam, film = _scene("parity_cornell.txt")
    assert fast_shade_mode(scene) == "bounce"  # the kernel covers it ...
    assert production_fast_shade(scene, cam, film) is False  # ... not here


def _subjaxprs(eqn):
    """Jaxprs nested in an equation's params (loop bodies, branches,
    pjit and pallas_call bodies)."""
    for v in eqn.params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            x = getattr(x, "jaxpr", x)  # ClosedJaxpr -> Jaxpr
            if hasattr(x, "eqns"):
                yield x


def _primitives(jaxpr):
    """Every primitive name in a jaxpr, sub-jaxprs included."""
    names = set()
    for eqn in jaxpr.eqns:
        names.add(eqn.primitive.name)
        for sub in _subjaxprs(eqn):
            names |= _primitives(sub)
    return names


def test_renderer_path_on_cpu_runs_no_kernel():
    """The Renderer's pass on the CPU (production path choice) traces no
    pallas_call: nothing runs a kernel in interpret mode unless a caller
    passes interpret=True."""
    from craytracer_tpu.integrator.pallas_shade import production_fast_shade
    from craytracer_tpu.integrator.render import _pass_step

    scene, cam, film = _scene("parity_cornell.txt")
    fast = production_fast_shade(scene, cam, film)
    pix = jnp.arange(film.num_pixels, dtype=jnp.int32)
    jaxpr = jax.make_jaxpr(lambda s, c, p: _pass_step(
        s, c, film, p, 0, 0, 3, fast_shade=fast))(scene, cam, pix)
    assert "pallas_call" not in _primitives(jaxpr.jaxpr)


def test_compile_cache_default_dir(monkeypatch):
    from craytracer_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_dir_is_left_alone(monkeypatch, tmp_path):
    from craytracer_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old  # nothing set


@pytest.mark.parametrize("m", [20, 1024, 1025, 5000])
def test_take_rows_equals_per_column_take(m):
    from craytracer_tpu.ops.gather import take_rows

    rng = np.random.default_rng(m)
    idx = jnp.asarray(rng.integers(-3, m + 3, size=777), jnp.int32)
    tabs = (jnp.asarray(rng.normal(size=(m, 3, 3)), jnp.float32),
            jnp.asarray(rng.normal(size=(m,)), jnp.float32),
            jnp.asarray(rng.integers(0, 1 << 20, size=m), jnp.int32),
            jnp.asarray(rng.random(m) < 0.5))
    got = take_rows(idx, tabs)
    for g, t in zip(got, tabs):
        want = jnp.take(t, jnp.clip(idx, 0, m - 1), axis=0)
        assert g.dtype == t.dtype and g.shape == want.shape
        np.testing.assert_array_equal(np.asarray(g), np.asarray(want))


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in _subjaxprs(eqn):
            out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("name", ["parity_cornell.txt",
                                  "parity_textured.txt"])
def test_render_pass_has_no_reduced_precision_matmul(name):
    """Without the test suite's precision pin, one render_sample pass has
    no dot_general below HIGHEST: on a GPU an unpinned float32 matmul may
    run in TF32 (about three decimal digits)."""
    from craytracer_tpu.integrator.wavefront import render_sample

    scene, cam, film = _scene(name)
    pix = jnp.arange(film.num_pixels, dtype=jnp.int32)
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", None)
    try:
        jaxpr = jax.make_jaxpr(lambda s, c, p: render_sample(
            s, c, film, p, 0, 0, 3))(scene, cam, pix)
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    hi = jax.lax.Precision.HIGHEST
    for prec in _dot_precisions(jaxpr.jaxpr):
        assert prec is not None and tuple(prec) == (hi, hi), prec


@pytest.mark.parametrize("shape", ["single", "batched", "broadcast"])
def test_mat3_apply_matches_einsum(shape):
    from craytracer_tpu.core import math as vm

    rng = np.random.default_rng(0)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    if shape == "single":
        m = rng.normal(size=(3, 3)).astype(np.float32)
        want = np.einsum("ij,nj->ni", m, v)
        got = vm.mat3_apply(jnp.asarray(m), jnp.asarray(v))
    elif shape == "batched":
        m = rng.normal(size=(6, 3, 3)).astype(np.float32)
        want = np.einsum("nij,nj->ni", m, v)
        got = vm.mat3_apply(jnp.asarray(m), jnp.asarray(v))
    else:
        m = rng.normal(size=(1, 4, 3, 3)).astype(np.float32)
        want = np.einsum("mij,nj->nmi", m[0], v)
        got = vm.mat3_apply(jnp.asarray(m), jnp.asarray(v)[:, None, :])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


def test_struct_dataclass_static_fields_specialise_jit():
    from craytracer_tpu.core import struct

    @struct.dataclass
    class Box:
        x: jnp.ndarray
        k: int = struct.field(pytree_node=False, default=1)

    traces = []

    @jax.jit
    def f(b):
        traces.append(b.k)
        return b.x * b.k

    b = Box(jnp.float32(2.0), k=3)
    assert float(f(b)) == 6.0
    assert float(f(b.replace(x=jnp.float32(4.0)))) == 12.0
    assert traces == [3]  # same static value: no retrace
    assert float(f(b.replace(k=5))) == 10.0
    assert traces == [3, 5]  # a new static value retraces
    assert jax.tree.leaves(b) == [b.x]
    with pytest.raises(Exception):
        b.x = 1.0  # frozen


def test_ppm_texture_loads_through_own_reader(tmp_path):
    from craytracer_tpu.io.image import write_ppm
    from craytracer_tpu.io.teximage import load_texture_image

    img = (np.arange(4 * 5 * 3).reshape(4, 5, 3) * 4).astype(np.uint8)
    p = str(tmp_path / "t.ppm")
    write_ppm(p, img)
    got = load_texture_image(p)
    assert got.dtype == np.float32 and got.shape == (4, 5, 3)
    np.testing.assert_array_equal(got, img.astype(np.float32) / 255.0)


def test_unreadable_texture_raises(tmp_path):
    from craytracer_tpu.io.teximage import load_texture_image

    p = tmp_path / "broken.png"
    p.write_bytes(b"not an image")
    with pytest.raises(Exception):
        load_texture_image(str(p))
