"""Tests of code that runs only on the card: the compiled whole-pass
megakernel (Triton has no CPU target; the CPU tests run it in the Pallas
interpreter) and the production path choice on the GPU backend.

Marked `gpu`: they skip elsewhere (the `gpu` fixture decides, at run
time) and run on the card in phase 6 of chip_smoke.py, in the same
process, without tests/conftest.py (which pins the CPU backend)."""

from __future__ import annotations

import os

import numpy as np
import pytest

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (backend is {dev.platform})")
    return dev


@pytest.mark.gpu
def test_production_path_is_megakernel_on_gpu(gpu):
    from craytracer_tpu.integrator.pallas_shade import production_fast_shade
    from craytracer_tpu.io.scenefile import load_scene_file

    scene, cam, film = load_scene_file(
        os.path.join(SCENES, "parity_cornell.txt"))
    assert production_fast_shade(scene, cam, film) == "bounce"
    mesh, cam_m, film_m = load_scene_file(
        os.path.join(SCENES, "parity_mesh.txt"))
    assert production_fast_shade(mesh, cam_m, film_m) is False


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "mix"])
def test_compiled_megakernel_matches_xla(gpu, name):
    """The compiled kernel against the XLA wavefront on the same rays.
    Triton contracts multiply-adds to FMA and has its own
    transcendentals, so a few lanes take another RR/BSDF branch: per-lane
    agreement to 1e-4*max(1,|L|) on >= 99.5% of lanes, counters within
    0.5%, image means within 0.2%."""
    import jax.numpy as jnp

    from craytracer_tpu.camera import generate_rays
    from craytracer_tpu.integrator.pallas_shade import fused_pass
    from craytracer_tpu.integrator.wavefront import CAMERA_BOUNCE, trace_paths
    from craytracer_tpu.io.scenefile import load_scene_file
    from craytracer_tpu.sampling import uniforms

    scene, cam, film = load_scene_file(
        os.path.join(SCENES, f"parity_{name}.txt"))
    film = film.replace(width=512, height=512)
    pix = jnp.arange(film.num_pixels, dtype=jnp.int32)
    o, d = generate_rays(cam, film, pix, uniforms(0, pix, 0, CAMERA_BOUNCE,
                                                  2, 0))
    Lx, gx, mx = trace_paths(scene, o, d, 0, pix, 0, 5, with_metrics=True)
    Lk, gk, mk = fused_pass(scene, o, d, pix, 0, 0, 5)
    Lx, Lk = np.asarray(Lx), np.asarray(Lk)
    close = np.abs(Lk - Lx) <= 1e-4 * np.maximum(1.0, np.abs(Lx))
    assert close.all(axis=1).mean() >= 0.995
    for key in ("rays", "shadow_rays"):
        assert abs(int(mk[key]) - int(mx[key])) <= 0.005 * int(mx[key])
    assert abs(Lk.mean() - Lx.mean()) <= 0.002 * abs(Lx.mean())
