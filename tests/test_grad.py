"""Differentiability tests: parameter gradients vs finite differences
(BASELINE.md "grads allclose"; SURVEY.md §7 step 7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from craytracer_tpu.camera import Film, make_camera
from craytracer_tpu.integrator.wavefront import render_sample
from craytracer_tpu.scene import SceneBuilder


def _simple_scene(albedo=0.5, intensity=30.0):
    b = SceneBuilder()
    b.add_matte("floor", (albedo, albedo, albedo))
    b.add_emissive("light", (1.0, 1.0, 1.0), intensity)
    b.add_rect((-50, 0, -50), (100, 0, 0), (0, 0, 100), "floor")
    b.add_rect((-5, 40, -5), (10, 0, 0), (0, 0, 10), "light")
    return b.build()


@jax.jit
def _loss_fn(scene, camera, film, ids):
    img = render_sample(scene, camera, film, ids, seed=3, spp_index=0,
                        max_depth=2, estimator="physical")
    return jnp.mean(img)


@pytest.fixture(scope="module")
def setup():
    scene = _simple_scene()
    camera = make_camera((0.0, 20.0, 60.0), (0.0, 5.0, 0.0))
    film = Film(fov=jnp.float32(np.deg2rad(45.0)), width=16, height=16)
    ids = jnp.arange(film.num_pixels, dtype=jnp.int32)
    return scene, camera, film, ids


def test_albedo_grad_matches_fd(setup):
    scene, camera, film, ids = setup

    def loss_of_albedo(a):
        s = scene.replace(
            materials=scene.materials.replace(
                color=scene.materials.color.at[1].set(jnp.stack([a, a, a]))
            )
        )
        return _loss_fn(s, camera, film, ids)

    a0 = jnp.float32(0.5)
    g = jax.grad(loss_of_albedo)(a0)
    eps = 1e-2
    fd = (loss_of_albedo(a0 + eps) - loss_of_albedo(a0 - eps)) / (2 * eps)
    # same RNG stream on all evals -> FD is exact up to curvature + f32 noise
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)
    assert float(g) > 0.0  # brighter albedo -> brighter image


def test_emission_grad_matches_fd(setup):
    scene, camera, film, ids = setup

    def loss_of_intensity(i):
        # the light table snapshots the emissive intensity at build time
        # (initAreaLights, buildscene.h:567-608): NEE differentiates through
        # lights.intensity, not materials.intensity
        s = scene.replace(
            lights=scene.lights.replace(
                intensity=scene.lights.intensity.at[0].set(i)
            )
        )
        return _loss_fn(s, camera, film, ids)

    i0 = jnp.float32(30.0)
    g = jax.grad(loss_of_intensity)(i0)
    eps = 0.5
    fd = (loss_of_intensity(i0 + eps) - loss_of_intensity(i0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)
    assert float(g) > 0.0


def test_light_color_grad_matches_fd(setup):
    """Gradient through the NEE light table (lights.color feeds ls.li)."""
    scene, camera, film, ids = setup

    def loss_of_light_r(r):
        s = scene.replace(
            lights=scene.lights.replace(
                color=scene.lights.color.at[0, 0].set(r)
            )
        )
        return _loss_fn(s, camera, film, ids)

    r0 = jnp.float32(1.0)
    g = jax.grad(loss_of_light_r)(r0)
    eps = 1e-2
    fd = (loss_of_light_r(r0 + eps) - loss_of_light_r(r0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)
    assert float(g) > 0.0


def test_multichip_dryrun():
    """The multi-device validation path: 8-device mesh, sharded forward +
    backward with grad psum, geometry sharding, and the whole-pass
    megakernel (interpret mode) under the ray-sharded mesh (see
    __graft_entry__)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8, interpret=True)


def test_camera_position_grad_matches_fd():
    """Camera gradients through the differentiable hit fill: a boundary-free
    scene (infinite plane + point light, depth 1) where the image is smooth
    in the camera position, so FD matches the interior gradient."""
    from craytracer_tpu.camera import make_camera

    b = SceneBuilder()
    b.add_matte("floor", (0.8, 0.8, 0.8))
    b.add_plane((0, 0, 0), (0, 1, 0), "floor")
    b.add_point_light((0, 8, 0), (1, 1, 1), intensity=60.0, dist_atten=True)
    scene = b.build()
    film = Film(fov=jnp.float32(np.deg2rad(35.0)), width=8, height=8)
    ids = jnp.arange(film.num_pixels, dtype=jnp.int32)

    base_cam = make_camera((2.0, 6.0, 14.0), (0.0, 0.0, 0.0))

    def loss_of_cam_x(x):
        # translate with the lookAt basis held fixed (pure position gradient)
        cam = base_cam.replace(
            position=jnp.stack([x, jnp.float32(6.0), jnp.float32(14.0)]))
        img = render_sample(scene, cam, film, ids, seed=3, spp_index=0,
                            max_depth=1, estimator="physical")
        return jnp.mean(img)

    x0 = jnp.float32(2.0)
    loss_of_cam_x = jax.jit(loss_of_cam_x)
    g = jax.jit(jax.grad(loss_of_cam_x))(x0)
    eps = 0.1
    fd = (loss_of_cam_x(x0 + eps) - loss_of_cam_x(x0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=0.15)
    assert abs(float(g)) > 1e-6  # nonzero: gradient actually flows


def test_remat_grad_matches(setup):
    """jax.checkpoint'ed bounces give identical gradients (recompute vs
    store)."""
    from craytracer_tpu.integrator.wavefront import trace_paths
    from craytracer_tpu.camera import generate_rays
    from craytracer_tpu.sampling import uniforms
    from craytracer_tpu.integrator.wavefront import CAMERA_BOUNCE

    scene, camera, film, ids = setup
    jitter = uniforms(3, ids, 0, CAMERA_BOUNCE, 2, 0)
    o, d = generate_rays(camera, film, ids, jitter)

    def loss(a, remat):
        s = scene.replace(materials=scene.materials.replace(
            color=scene.materials.color.at[1].set(jnp.stack([a, a, a]))))
        L, good = trace_paths(s, o, d, 3, ids, 0, 2, remat=remat)
        return jnp.mean(L)

    a0 = jnp.float32(0.5)
    g_plain = jax.grad(lambda a: loss(a, False))(a0)
    g_remat = jax.grad(lambda a: loss(a, True))(a0)
    np.testing.assert_allclose(float(g_plain), float(g_remat), rtol=1e-5)


def test_look_point_grad_flows():
    """make_camera_jax: gradients flow through the lookAt basis (camera
    orientation optimization)."""
    from craytracer_tpu.camera import make_camera_jax

    b = SceneBuilder()
    b.add_matte("floor", (0.8, 0.8, 0.8))
    b.add_plane((0, 0, 0), (0, 1, 0), "floor")
    b.add_point_light((0, 8, 0), (1, 1, 1), intensity=60.0, dist_atten=True)
    scene = b.build()
    film = Film(fov=jnp.float32(np.deg2rad(35.0)), width=8, height=8)
    ids = jnp.arange(film.num_pixels, dtype=jnp.int32)

    @jax.jit
    def loss_of_look_x(lx):
        cam = make_camera_jax((2.0, 6.0, 14.0), jnp.stack([lx, jnp.float32(0.0),
                                                           jnp.float32(0.0)]))
        img = render_sample(scene, cam, film, ids, seed=3, spp_index=0,
                            max_depth=1, estimator="physical")
        return jnp.mean(img)

    x0 = jnp.float32(0.5)
    g = jax.jit(jax.grad(loss_of_look_x))(x0)
    eps = 0.05
    fd = (loss_of_look_x(x0 + eps) - loss_of_look_x(x0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=0.2)
    assert abs(float(g)) > 1e-6


def _textured_scene():
    b = SceneBuilder()
    tex = np.linspace(0.2, 0.8, 4 * 4 * 3, dtype=np.float32).reshape(4, 4, 3)
    tid = b.add_texture("checker", tex)
    b.add_matte("floor", (1.0, 1.0, 1.0), diffuse_tex=tid)
    b.add_emissive("light", (1.0, 1.0, 1.0), 30.0)
    b.add_rect((-50, 0, -50), (100, 0, 0), (0, 0, 100), "floor")
    b.add_rect((-5, 40, -5), (10, 0, 0), (0, 0, 10), "light")
    return b.build()


def test_texture_texel_grad_matches_fd():
    """North-star requirement: gradients w.r.t. texels through the
    nearest-neighbor lookup gather (texture.cpp:27-86 analog)."""
    scene = _textured_scene()
    camera = make_camera((0.0, 20.0, 60.0), (0.0, 5.0, 0.0))
    film = Film(fov=jnp.float32(np.deg2rad(45.0)), width=16, height=16)
    ids = jnp.arange(film.num_pixels, dtype=jnp.int32)

    def loss_of_texel(v):
        tx = scene.textures.texels.at[5, 1].set(v)  # one texel channel
        s = scene.replace(textures=scene.textures.replace(texels=tx))
        return _loss_fn(s, camera, film, ids)

    v0 = jnp.float32(0.5)
    g = jax.grad(loss_of_texel)(v0)
    eps = 1e-2
    fd = (loss_of_texel(v0 + eps) - loss_of_texel(v0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)
    assert float(g) > 0.0


def test_metal_roughness_grad_matches_fd():
    """BASELINE inverse config names microfacet params: d(loss)/d(alphax)
    through the metal lobe's D/G/sample chain."""
    b = SceneBuilder()
    mid = b.add_metal("m", preset="GOLD", roughness=0.25)
    b.add_matte("w", (0.5, 0.5, 0.5))
    b.add_emissive("light", (1.0, 1.0, 1.0), 30.0)
    b.add_rect((-50, 0, -50), (100, 0, 0), (0, 0, 100), "w")
    b.add_sphere((0.0, 6.0, 0.0), 6.0, "m")
    b.add_rect((-5, 40, -5), (10, 0, 0), (0, 0, 10), "light")
    scene = b.build()
    camera = make_camera((0.0, 15.0, 40.0), (0.0, 5.0, 0.0))
    film = Film(fov=jnp.float32(np.deg2rad(45.0)), width=16, height=16)
    ids = jnp.arange(film.num_pixels, dtype=jnp.int32)

    def loss_of_alpha(a):
        mats = scene.materials.replace(
            alphax=scene.materials.alphax.at[mid].set(a),
            alphay=scene.materials.alphay.at[mid].set(a))
        return _loss_fn(scene.replace(materials=mats), camera, film, ids)

    a0 = jnp.float32(scene.materials.alphax[mid])
    g = jax.grad(loss_of_alpha)(a0)
    eps = 1e-3
    fd = (loss_of_alpha(a0 + eps) - loss_of_alpha(a0 - eps)) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=5e-2, atol=1e-4)
