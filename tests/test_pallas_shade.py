"""Whole-pass megakernel (integrator/pallas_shade.py) vs the XLA wavefront:
same scene, same rays, same RNG counters -> the per-pass radiance and
good_paths must agree to f32 rounding (2e-5; 5e-5 for the microfacet
scenes, whose longer transcendental chains round differently in the
interpreter), at every bounce depth. Runs the kernel in interpret mode on
the CPU backend; the compiled kernel's agreement is checked on the card
by chip_smoke.py."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from craytracer_tpu.camera import generate_rays
from craytracer_tpu.integrator.wavefront import (CAMERA_BOUNCE, render_sample,
                                                 trace_paths)
from craytracer_tpu.integrator.pallas_shade import fast_shade_ok
from craytracer_tpu.io.scenefile import load_scene_file
from craytracer_tpu.sampling import uniforms


def _cornell(size=24):
    scene, cam, film = load_scene_file(os.path.join(
        os.path.dirname(__file__), "..", "scenes", "parity_cornell.txt"))
    film = film.replace(width=size, height=size)
    return scene, cam, film


def test_fast_shade_gate():
    scene, _, _ = _cornell()
    assert fast_shade_ok(scene)  # matte+emissive, rect lights, black env

    # a scene with a non-matte material must fall back
    from craytracer_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.add_matte("w", (0.5, 0.5, 0.5))
    b.add_metal("m", "GOLD", 0.1)
    b.add_sphere((0, 0, 0), 1.0, "m")
    b.add_rect((-1, 2, -1), (2, 0, 0), (0, 0, 2), "w")
    assert not fast_shade_ok(b.build())


def test_bounce_mode_gate():
    from craytracer_tpu.integrator.pallas_shade import fast_shade_mode

    scene, _, _ = _cornell()
    # cornell: 8 rects + 20 flat triangles, no accel tables -> the
    # whole-pass kernel applies
    assert fast_shade_mode(scene) == "bounce"


@pytest.mark.parametrize("depth", [0, 2, 5])
@pytest.mark.parametrize("mode", ["bounce"])
def test_fast_shade_matches_xla(depth, mode):
    scene, cam, film = _cornell()
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    jit = uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 0)
    o, d = generate_rays(cam, film, pix, jit)

    L_ref, good_ref, m_ref = trace_paths(scene, o, d, 0, pix, 0, depth,
                                         with_metrics=True)
    L_fast, good_fast, m_fast = trace_paths(scene, o, d, 0, pix, 0, depth,
                                            with_metrics=True,
                                            fast_shade=mode, interpret=True)
    np.testing.assert_allclose(np.asarray(L_fast), np.asarray(L_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(good_fast),
                                  np.asarray(good_ref))
    assert int(m_fast["rays"]) == int(m_ref["rays"])
    assert int(m_fast["shadow_rays"]) == int(m_ref["shadow_rays"])


@pytest.mark.parametrize("mode", ["bounce"])
def test_fast_shade_mirror_sphere_matches_xla(mode):
    """Round-5 extensions: MIRROR lobe + sphere primitives (incl. the
    clipped-sphere window and the unclamped-acos quirk) in the fused
    path, against the XLA step on the same rays."""
    from craytracer_tpu.camera import Film, make_camera
    from craytracer_tpu.integrator.pallas_shade import fast_shade_mode
    from craytracer_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_matte("r", (0.6, 0.1, 0.1))
    b.add_mirror("m", (0.9, 0.9, 0.9))
    b.add_emissive("lamp", (1.0, 0.9, 0.8), 20.0)
    b.add_rect((-4, 0, -4), (8, 0, 0), (0, 0, 8), "w")      # floor
    b.add_rect((-4, 0, -4), (8, 0, 0), (0, 4, 0), "r")      # back wall
    b.add_sphere((0.8, 1.0, 0.5), 1.0, "m")                  # mirror ball
    b.add_sphere((-1.4, 0.7, -0.5), 0.7, "w")                # matte ball
    # clipped sphere (phi/theta window + unclamped-acos quirk coverage)
    b.add_sphere((0.0, 0.4, 1.8), 0.4, "r", phi=2.0,
                 min_theta=0.5, max_theta=2.5)
    b.add_rect((-1, 3.5, -1), (2, 0, 0), (0, 0, 2), "lamp")
    scene = b.build()
    assert fast_shade_mode(scene) == "bounce"

    cam = make_camera((0, 2.2, 6.0), (0, 1.0, 0))
    film = Film(fov=jnp.float32(0.8), width=32, height=32)
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    jit = uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 0)
    o, d = generate_rays(cam, film, pix, jit)

    L_ref, good_ref, m_ref = trace_paths(scene, o, d, 0, pix, 0, 4,
                                         with_metrics=True)
    L_fast, good_fast, m_fast = trace_paths(scene, o, d, 0, pix, 0, 4,
                                            with_metrics=True,
                                            fast_shade=mode, interpret=True)
    np.testing.assert_allclose(np.asarray(L_fast), np.asarray(L_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(good_fast),
                                  np.asarray(good_ref))
    assert int(m_fast["rays"]) == int(m_ref["rays"])
    assert int(m_fast["shadow_rays"]) == int(m_ref["shadow_rays"])


@pytest.mark.parametrize("mode", ["bounce"])
def test_fast_shade_sphere_light_matches_xla(mode):
    """Sphere AREA lights in the fused path (cosine hemisphere about the
    center->hit axis, trace.h:230-243) vs the XLA step."""
    from craytracer_tpu.camera import Film, make_camera
    from craytracer_tpu.integrator.pallas_shade import fast_shade_mode
    from craytracer_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_emissive("lamp", (1.0, 0.9, 0.7), 25.0)
    b.add_rect((-4, 0, -4), (8, 0, 0), (0, 0, 8), "w")
    b.add_sphere((-1.0, 0.8, 0.0), 0.8, "w")
    b.add_sphere((1.5, 2.5, 0.5), 0.5, "lamp")  # sphere AREA light
    scene = b.build()
    assert fast_shade_mode(scene) == "bounce"

    cam = make_camera((0, 2.0, 5.5), (0, 0.8, 0))
    film = Film(fov=jnp.float32(0.8), width=32, height=32)
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    jit = uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 0)
    o, d = generate_rays(cam, film, pix, jit)

    L_ref, good_ref, m_ref = trace_paths(scene, o, d, 0, pix, 0, 4,
                                         with_metrics=True)
    L_fast, good_fast, m_fast = trace_paths(scene, o, d, 0, pix, 0, 4,
                                            with_metrics=True,
                                            fast_shade=mode, interpret=True)
    np.testing.assert_allclose(np.asarray(L_fast), np.asarray(L_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(good_fast),
                                  np.asarray(good_ref))
    assert int(m_fast["rays"]) == int(m_ref["rays"])
    assert int(m_fast["shadow_rays"]) == int(m_ref["shadow_rays"])


def test_fused_raygen_plain_matches_xla():
    """raygen='plain' in the megakernel (CAMERA_BOUNCE jitter + pinhole
    math in-kernel) vs generate_rays + the XLA step."""
    from craytracer_tpu.integrator.pallas_shade import fused_pass

    scene, cam, film = _cornell(24)
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    jit = uniforms(0, pix, 5, CAMERA_BOUNCE, 2, 0)
    o, d = generate_rays(cam, film, pix, jit)
    L_ref, good_ref, m_ref = trace_paths(scene, o, d, 0, pix, 5, 4,
                                         with_metrics=True)
    L_f, good_f, m_f = fused_pass(scene, None, None, pix, 5, 0, 4,
                                  raygen="plain", camera=cam, film=film,
                                  width=int(film.width), interpret=True)
    np.testing.assert_allclose(np.asarray(L_f), np.asarray(L_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(good_f), np.asarray(good_ref))
    assert int(m_f["rays"]) == int(m_ref["rays"])
    assert int(m_f["shadow_rays"]) == int(m_ref["shadow_rays"])


def test_fused_raygen_strat_through_render_sample():
    """render_sample(fast_shade='bounce') takes the fully-fused pass
    (stratified jitter + raygen in-kernel) and must match the XLA
    render_sample, including per-lane spp batching."""
    scene, cam, film = _cornell(16)
    n = film.num_pixels
    pix = jnp.tile(jnp.arange(n, dtype=jnp.int32), 2)
    spp = jnp.repeat(jnp.arange(2, dtype=jnp.int32), n)
    ref = render_sample(scene, cam, film, pix, 3, spp, 6)
    fast = render_sample(scene, cam, film, pix, 3, spp, 6,
                         fast_shade="bounce", interpret=True)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["bounce"])
def test_fast_shade_oren_plastic_metal_matches_xla(mode):
    """Round-5 late extensions: Oren-Nayar matte (sigma != 0), PLASTIC
    (two-lobe FresnelBlend, isotropic Beckmann) and METAL (conductor
    microfacet) in the fused path — the parity_mix material family —
    against the XLA step on the same rays."""
    from craytracer_tpu.camera import Film, make_camera
    from craytracer_tpu.integrator.pallas_shade import fast_shade_mode
    from craytracer_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.add_matte("grey", (0.73, 0.73, 0.73))
    b.add_matte("rough_blue", (0.2, 0.3, 0.7), sigma=20.0)
    b.add_plastic("red_plastic", kd=(0.6, 0.05, 0.05),
                  ks=(0.4, 0.4, 0.4), roughness=0.08)
    b.add_mirror("chrome", (0.9, 0.9, 0.9))
    b.add_metal("gold", "GOLD", 0.1)
    b.add_emissive("lamp", (1.0, 0.95, 0.85), 14.0)
    b.add_rect((-6, 0, -6), (12, 0, 0), (0, 0, 12), "grey")
    b.add_sphere((-2.2, 0.8, 0.0), 0.8, "rough_blue")
    b.add_sphere((-0.7, 0.8, 0.8), 0.8, "red_plastic")
    b.add_sphere((0.9, 0.8, -0.3), 0.8, "chrome")
    b.add_sphere((2.4, 0.8, 0.6), 0.8, "gold")
    b.add_rect((-1.5, 4, -1.5), (3, 0, 0), (0, 0, 3), "lamp")
    scene = b.build()
    assert fast_shade_mode(scene) == "bounce"
    assert not scene.matte_lambertian  # sigma 20 -> full Oren-Nayar

    cam = make_camera((0, 2.0, 6.5), (0, 0.8, 0))
    film = Film(fov=jnp.float32(0.8), width=32, height=32)
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    jit = uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 0)
    o, d = generate_rays(cam, film, pix, jit)

    L_ref, good_ref, m_ref = trace_paths(scene, o, d, 0, pix, 0, 4,
                                         with_metrics=True)
    L_fast, good_fast, m_fast = trace_paths(scene, o, d, 0, pix, 0, 4,
                                            with_metrics=True,
                                            fast_shade=mode, interpret=True)
    np.testing.assert_allclose(np.asarray(L_fast), np.asarray(L_ref),
                               rtol=5e-5, atol=5e-5)
    np.testing.assert_array_equal(np.asarray(good_fast),
                                  np.asarray(good_ref))
    assert int(m_fast["rays"]) == int(m_ref["rays"])
    assert int(m_fast["shadow_rays"]) == int(m_ref["shadow_rays"])


@pytest.mark.parametrize("mode", ["bounce"])
def test_fast_shade_glass_transparent_matches_xla(mode):
    """GLASS (microfacet fresnel refl/trans, incl. the reference's
    1-Fr(wh,wi) reflection quirk) and TRANSPARENT (thin) in the fused
    path — the full 7-type material family now runs in-kernel."""
    from craytracer_tpu.camera import Film, make_camera
    from craytracer_tpu.integrator.pallas_shade import fast_shade_mode
    from craytracer_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.add_matte("grey", (0.7, 0.7, 0.7))
    b.add_glass("glass", ior_in=1.5, ior_out=1.0, roughness=0.05)
    b.add_transparent("thin", ior_in=1.5, ior_out=1.0)
    b.add_emissive("lamp", (1.0, 0.95, 0.85), 16.0)
    b.add_rect((-6, 0, -6), (12, 0, 0), (0, 0, 12), "grey")
    b.add_sphere((-1.0, 0.9, 0.0), 0.9, "glass")
    b.add_sphere((1.3, 0.7, 0.6), 0.7, "thin")
    b.add_rect((-1.5, 4, -1.5), (3, 0, 0), (0, 0, 3), "lamp")
    scene = b.build()
    assert fast_shade_mode(scene) == "bounce"

    cam = make_camera((0, 2.0, 6.0), (0, 0.8, 0))
    film = Film(fov=jnp.float32(0.8), width=32, height=32)
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    jit = uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 0)
    o, d = generate_rays(cam, film, pix, jit)

    L_ref, good_ref, m_ref = trace_paths(scene, o, d, 0, pix, 0, 5,
                                         with_metrics=True)
    L_fast, good_fast, m_fast = trace_paths(scene, o, d, 0, pix, 0, 5,
                                            with_metrics=True,
                                            fast_shade=mode, interpret=True)
    np.testing.assert_allclose(np.asarray(L_fast), np.asarray(L_ref),
                               rtol=5e-5, atol=5e-5)
    np.testing.assert_array_equal(np.asarray(good_fast),
                                  np.asarray(good_ref))
    assert int(m_fast["rays"]) == int(m_ref["rays"])
    assert int(m_fast["shadow_rays"]) == int(m_ref["shadow_rays"])


def test_fused_raygen_wide_film_rowcol_exact():
    """Regression (review finding): the f32 reciprocal row estimate
    misassigned end-of-row pixels on films whose 1/width is inexact
    (e.g. 1920). The residual correction must keep row/col exact —
    fused raygen vs the XLA raygen on a 1920-wide film."""
    scene, cam, film = _cornell()
    film = film.replace(width=1920, height=8)
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    ref = render_sample(scene, cam, film, pix, 1, 0, 1)
    fast = render_sample(scene, cam, film, pix, 1, 0, 1,
                         fast_shade="bounce", interpret=True)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["bounce"])
def test_fast_shade_plane_disk_matches_xla(mode):
    """Planes + disks in the whole-bounce prim table (round-5 fast-path
    coverage extension): unbounded single-sided plane (no facing flip,
    _fill_plane), disk with the facing flip and orthonormal-basis dpdu
    (_fill_disk) — including a disk whose stored normal faces AWAY from
    the camera so the flip leg is exercised — vs the XLA step on the
    same rays. Tie-break group order (sphere, plane, rect, disk, tri)
    must match intersect_scene's."""
    from craytracer_tpu.camera import Film, make_camera
    from craytracer_tpu.integrator.pallas_shade import fast_shade_mode
    from craytracer_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_matte("g", (0.2, 0.6, 0.2))
    b.add_matte("b", (0.2, 0.3, 0.7))
    b.add_mirror("m", (0.9, 0.9, 0.9))
    b.add_emissive("lamp", (1.0, 0.9, 0.8), 18.0)
    b.add_plane((0, 0, 0), (0, 1, 0), "w")                   # ground
    b.add_plane((0, 0, -4), (0, 0, 1), "g")                  # back
    b.add_disk((-1.2, 1.0, -1.0), (0.3, 0.2, 1.0), 0.8, "b")
    # flipped-leg disk: stored normal points away from the camera
    b.add_disk((1.4, 0.9, -0.5), (0, 0, -1), 0.6, "g")
    b.add_sphere((0.2, 0.7, 0.6), 0.7, "m")                  # mirror ball
    b.add_triangle((-0.5, 0.0, 1.8), (0.6, 0.0, 1.6),
                   (0.0, 1.1, 1.7), "b")
    b.add_rect((-1, 3.2, -1), (2, 0, 0), (0, 0, 2), "lamp")
    scene = b.build()
    assert fast_shade_mode(scene) == "bounce"

    cam = make_camera((0, 1.8, 5.5), (0, 0.9, 0))
    film = Film(fov=jnp.float32(0.85), width=32, height=32)
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    jit = uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 0)
    o, d = generate_rays(cam, film, pix, jit)

    L_ref, good_ref, m_ref = trace_paths(scene, o, d, 0, pix, 0, 4,
                                         with_metrics=True)
    L_fast, good_fast, m_fast = trace_paths(scene, o, d, 0, pix, 0, 4,
                                            with_metrics=True,
                                            fast_shade=mode, interpret=True)
    np.testing.assert_allclose(np.asarray(L_fast), np.asarray(L_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(good_fast),
                                  np.asarray(good_ref))
    assert int(m_fast["rays"]) == int(m_ref["rays"])
    assert int(m_fast["shadow_rays"]) == int(m_ref["shadow_rays"])


def test_fused_raygen_thinlens_matches_xla():
    """Thin-lens camera in the in-kernel raygen (calcRayThinLens port,
    camera.py:146-169): polar-warp lens disk from CAMERA_BOUNCE dims 2,3,
    direction normalized in camera space before the world transform —
    vs the XLA raygen + step path through render_sample."""
    from craytracer_tpu.camera import THINLENS

    scene, cam0, film = _cornell()
    # focus on the back wall (unit-scale box, camera 1.458 in front)
    cam = cam0.replace(camera_type=THINLENS,
                       focal_length=jnp.float32(1.458),
                       lens_radius=jnp.float32(0.0036))
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    ref = render_sample(scene, cam, film, pix, 2, 0, 4)
    assert float(np.asarray(ref).mean()) > 0.1  # non-vacuous image
    fast = render_sample(scene, cam, film, pix, 2, 0, 4,
                         fast_shade="bounce", interpret=True)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["bounce"])
def test_fast_shade_aabox_matches_xla(mode):
    """Instanced AABOX in the whole-bounce prim table: world->object
    affine in the box table (rotated + scaled boxes), the exact _aabox_ts slab
    test, the face-plane Newton t refinement, dominant-axis normal
    through (M^-1)^T, faced toward the ray (_fill_instanced box legs) —
    vs the XLA step on the same rays. Boxes index after every other
    group (instanced is last in _GROUPS)."""
    from craytracer_tpu.camera import Film, make_camera
    from craytracer_tpu.integrator.pallas_shade import fast_shade_mode
    from craytracer_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_matte("r", (0.6, 0.15, 0.1))
    b.add_mirror("m", (0.9, 0.9, 0.9))
    b.add_emissive("lamp", (1.0, 0.9, 0.8), 18.0)
    b.add_plane((0, 0, 0), (0, 1, 0), "w")                   # ground
    b.add_box(1.2, 0.8, 0.9, "r", location=(-1.1, 0.4, 0.2),
              orientation=(0, 30, 0))                        # rotated box
    b.add_box(0.6, 1.6, 0.6, "w", location=(0.9, 0.8, -0.6),
              scale=(1.0, 1.0, 1.3), orientation=(10, -20, 5))
    b.add_sphere((0.1, 0.45, 1.4), 0.45, "m")
    b.add_rect((-1, 3.0, -1), (2, 0, 0), (0, 0, 2), "lamp")
    scene = b.build()
    assert fast_shade_mode(scene) == "bounce"

    cam = make_camera((0, 1.6, 5.0), (0, 0.7, 0))
    film = Film(fov=jnp.float32(0.85), width=32, height=32)
    n = film.num_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    jit = uniforms(0, pix, 0, CAMERA_BOUNCE, 2, 0)
    o, d = generate_rays(cam, film, pix, jit)

    L_ref, good_ref, m_ref = trace_paths(scene, o, d, 0, pix, 0, 4,
                                         with_metrics=True)
    assert float(np.asarray(L_ref).mean()) > 0.01  # non-vacuous
    L_fast, good_fast, m_fast = trace_paths(scene, o, d, 0, pix, 0, 4,
                                            with_metrics=True,
                                            fast_shade=mode, interpret=True)
    np.testing.assert_allclose(np.asarray(L_fast), np.asarray(L_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(good_fast),
                                  np.asarray(good_ref))
    assert int(m_fast["rays"]) == int(m_ref["rays"])
    assert int(m_fast["shadow_rays"]) == int(m_ref["shadow_rays"])
