"""Raycast / Whitted integrators.

The reference declares RAYCAST and WHITTED trace types (trace.h:17-23) whose
dispatch entries are commented out (trace.h:48-73, the shipped binary always
path-traces); the light machinery they rely on (per-light direct sums,
delta lights, AO probes) still exists. This module provides working
wavefront versions so the trace_type config is fully honored:

* raycast: first-hit direct lighting — emitted + a sum over ALL lights with
  shadow tests (the classic ray-casting estimator).
* whitted: raycast + recursive perfect-specular continuation (mirror /
  transparent), with the Fresnel branch chosen stochastically per lane.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from craytracer_tpu.bsdf import bsdf_f_direct, bsdf_sample, gather_params
from craytracer_tpu.constants import K_EPSILON
from craytracer_tpu.core import math as vm
from craytracer_tpu.integrator.wavefront import _offset_ray, _DIM_BSDF, _DIM_LIGHT
from craytracer_tpu.lights import env_radiance
from craytracer_tpu.lights.lights import sample_light_index
from craytracer_tpu.ops import intersect_scene, shadow_distance
from craytracer_tpu.sampling import uniforms
from craytracer_tpu.scene import types as T


def trace_whitted(scene: T.Scene, origin, direction, seed, pixel_ids, spp_index,
                  max_depth: int, specular_continuation: bool = True):
    """Returns L[N,3]. `specular_continuation=False` gives raycast."""
    n = origin.shape[0]
    num_lights = scene.lights.light_type.shape[0]
    depth_iters = (max_depth + 1) if specular_continuation else 1

    def body(bounce, state):
        o, d, beta, L, alive = state
        hit = intersect_scene(scene, o, d)
        miss = ~hit.hit_mask
        mat_type = jnp.take(scene.materials.mat_type, hit.mat_id)
        emissive_hit = hit.hit_mask & (mat_type == T.MAT_EMISSIVE)

        # background/env on miss
        env_dir = vm.mat3_apply(scene.env.transform, d)
        env_li = env_radiance(scene.env, scene.textures, env_dir)
        L = L + jnp.where((alive & miss)[:, None], beta * env_li, 0.0)

        e_color = jnp.take(scene.materials.color, hit.mat_id, axis=0)
        e_int = jnp.take(scene.materials.intensity, hit.mat_id)
        L = L + jnp.where((alive & emissive_hit)[:, None],
                          beta * e_color * e_int[:, None], 0.0)

        cont = alive & hit.hit_mask & ~emissive_hit
        ft, fb, fn = vm.make_shading_frame(hit.normal, hit.dpdu)
        mp = gather_params(scene.materials, scene.textures, hit.mat_id, hit.uv,
                           lambertian_only=scene.matte_lambertian)
        wo_local = vm.to_local(-d, ft, fb, fn)

        # direct lighting: deterministic sum over every light
        shadow_o = _offset_ray(hit.point, hit.normal, fn)
        for li_idx in range(num_lights):
            u2 = uniforms(seed, pixel_ids, spp_index, bounce, 2,
                          _DIM_LIGHT + 16 + 2 * li_idx)
            idx = jnp.full((n,), li_idx, jnp.int32)
            ls = sample_light_index(scene, idx, u2, hit.point, fn, ft, fb)
            wi_l = vm.to_local(ls.wi, ft, fb, fn)
            f = bsdf_f_direct(wi_l, wo_local, mp) * jnp.abs(vm.dot(fn, ls.wi))[:, None]
            want = cont & ls.valid & jnp.any(f > 0.0, axis=-1)
            so = _offset_ray(hit.point, hit.normal, ls.wi)
            # offset-adjusted bound (see wavefront.py shadow test)
            d_adj = ls.distance - vm.dot(so - hit.point, ls.wi)
            t_sh = shadow_distance(scene, so, ls.wi, d_adj)
            lit = t_sh >= d_adj - jnp.maximum(K_EPSILON, 1e-3 * d_adj)
            L = L + jnp.where((want & lit)[:, None],
                              beta * f * ls.li / jnp.maximum(ls.pdf, 1e-12)[:, None],
                              0.0)

        if not specular_continuation:
            return o, d, beta, L, jnp.zeros_like(alive)

        # specular continuation only (mirror/transparent/glass)
        u_b = uniforms(seed, pixel_ids, spp_index, bounce, 3, _DIM_BSDF)
        f_s, wi_local, pdf_s, is_spec, is_glossy = bsdf_sample(u_b, wo_local, mp)
        spec = cont & (is_spec | ((mat_type == T.MAT_GLASS)))
        wi_world = vm.to_world(wi_local, ft, fb, fn)
        weight = f_s * (jnp.abs(vm.dot(wi_world, fn))
                        / jnp.maximum(pdf_s, 1e-12))[:, None]
        new_beta = jnp.where(spec[:, None], beta * weight, beta)
        new_alive = spec & (pdf_s > 0.0) & (bounce < max_depth)
        new_o = jnp.where(spec[:, None], _offset_ray(hit.point, hit.normal, wi_world), o)
        new_d = jnp.where(spec[:, None], wi_world, d)
        return new_o, new_d, new_beta, L, new_alive

    state = (
        origin, direction,
        jnp.ones((n, 3), origin.dtype),
        jnp.zeros((n, 3), origin.dtype),
        jnp.ones((n,), bool),
    )
    state = jax.lax.fori_loop(0, depth_iters, body, state)
    return state[3]


def trace_raycast(scene, origin, direction, seed, pixel_ids, spp_index):
    return trace_whitted(scene, origin, direction, seed, pixel_ids, spp_index,
                         max_depth=0, specular_continuation=False)
