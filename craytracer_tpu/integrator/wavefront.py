"""Wavefront path tracer with next-event estimation.

The reference's recursive-per-ray `pathTrace` (trace.h:399-532) becomes a
bounce loop over an `[N]`-lane ray queue: every stage (intersect, emitted
add, NEE, BSDF sample, Russian roulette) is one fused batched computation
with liveness masks. Estimator semantics follow the reference exactly —
including its idiosyncrasies, so images match:

* radiance is divided by `good_paths`, the count of contributing events
  (trace.h:528-529);
* `good_paths` increments on: emissive hit or escape when (bounce 0 or the
  previous bounce sampled a specular/glossy lobe) — escapes count even when
  the env contribution is black (trace.h:419-455) — and on nonzero NEE
  contributions (trace.h:473-477);
* NEE runs only for materials outside {MIRROR, TRANSPARENT, GLASS}
  (trace.h:471) and evaluates only non-specular, non-glossy lobes
  (excluded_from_direct, trace.h:410);
* termination: escape, max depth, or an emissive hit (trace.h:459);
* Russian roulette after bounce 3 with q = max(0.05, 1 - max(beta)),
  surviving paths scaled by 1/(1-q) (trace.h:512-525).

Deviation (robustness, documented): ray origins are offset along the
geometric normal by a magnitude-relative epsilon instead of relying on the
reference's absolute K_EPSILON=7e-6 t-cull (util/constants.h:45), which is
below f32 resolution at Cornell-box scale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from craytracer_tpu.bsdf import bsdf_f_direct, bsdf_sample, gather_params
from craytracer_tpu.constants import K_EPSILON, TMAX
from craytracer_tpu.core import math as vm
from craytracer_tpu.lights import env_radiance, sample_one_light
from craytracer_tpu.ops import intersect_scene, shadow_distance
from craytracer_tpu.sampling import uniforms
from craytracer_tpu.scene import types as T

# RNG dimension layout per bounce (disjoint counters per call site).
_DIM_LIGHT = 0  # light_sample (2)
_DIM_SCATTER = 2  # scatter_sample (2, consumed-but-unused as in trace.h:468)
_DIM_PICK = 4  # light selection rand (trace.h:371)
_DIM_BSDF = 5  # BSDF sample (2) + fresnel-branch rand (3)
_DIM_RR = 8  # Russian roulette rand (trace.h:516)
CAMERA_BOUNCE = 0x7FFF  # bounce counter reserved for camera jitter dims


def _offset_ray(point, normal, direction):
    """Nudge origins off the surface along the geometric normal, scaled to
    local magnitude (f32-robust replacement for the t > K_EPSILON cull)."""
    mag = vm.max3(jnp.abs(point), keepdims=True)
    eps = (mag + 1.0) * 1e-4
    side = jnp.where(vm.dot(direction, normal, keepdims=True) >= 0.0, 1.0, -1.0)
    return point + normal * eps * side


def _make_bounce_step(scene: T.Scene, seed, spp_index,
                      max_depth: int, rr_start: int = 3, mis: bool = False,
                      geom_axis: str | None = None, tri_base=None):
    """Build the per-bounce wavefront step. Returns a function
    (bounce, state) -> (new_state, aux) where aux carries the per-bounce
    log record (SampleLog, trace.h:176-219). Shared by trace_paths (fori,
    aux discarded) and trace_paths_logged (unrolled, aux stacked).

    `mis=True` switches to the multiple-importance-sampling estimator the
    reference stubs but never uses (powerHeuristic, trace.h:166-169):
    emitted/env light is added at EVERY bounce weighted against the NEE
    strategy's density, NEE covers all finite lobes (glossy included) and
    is weighted against the balanced BSDF density — a strict quality
    improvement over the reference's spec/glossy-only re-add rule."""
    # Static lobe gate: material types absent from the scene compile away.
    present = frozenset(scene.mat_types_present) or None

    def step(bounce, state, cam0: bool = False):
        (o, d, beta, L, good, alive, prev_sg, rays, shadows, live_hist,
         prev_pdf, prev_delta, prev_n, pix, lane) = state

        # Detached traversal with differentiable fill (SURVEY.md §7 step 7):
        # intersect_scene detaches the discrete search and re-derives
        # t/normal/uv differentiably for the winning primitive (implicit-
        # function reparametrization), so interior gradients flow w.r.t.
        # camera rays and scene geometry. `cam0` marks the peeled bounce-0
        # call: Morton-tiled camera rays may take the coherent-tile accel
        # (T.Scene.tri_cam).
        hit = intersect_scene(scene, o, d, camera_coherent=cam0)
        if geom_axis is not None and hit is not None:
            # Geometry sharding (SURVEY.md §5.7, the SP/CP analog): this
            # device only holds a triangle shard; argmin-reduce the per-
            # shard closest hits across the mesh axis so shading (which is
            # replicated along it) sees the global winner.
            from craytracer_tpu.parallel.geom import reduce_hit

            hit = reduce_hit(hit, geom_axis, tri_base)
        miss = ~hit.hit_mask
        # One fused material-row lookup per bounce serves the emissive add,
        # the NEE masks, the normal map id, and the BSDF parameters.
        mp = gather_params(scene.materials, scene.textures, hit.mat_id, hit.uv,
                           lambertian_only=scene.matte_lambertian)
        mat_type = mp.mat_type
        emissive_hit = hit.hit_mask & (mat_type == T.MAT_EMISSIVE)

        # ---- emitted / env radiance (trace.h:419-455)
        emitted = mp.color_raw * mp.intensity[:, None]
        if scene.env.kind == 0:  # static: no env light, skip the transform
            env_li = jnp.zeros_like(d)
        else:
            env_dir = vm.mat3_apply(scene.env.transform, d)
            env_li = env_radiance(scene.env, scene.textures, env_dir)
        if mis:
            from craytracer_tpu.lights.lights import env_pdf, light_pdf_for_hit

            no_compete = (bounce == 0) | prev_delta
            p_l = light_pdf_for_hit(scene, hit.group, hit.prim, hit.point, o, d,
                                    hit_normal=hit.normal)
            # NEE rejects directions below the previous shading normal
            # (trace.h:316-323); the light strategy has zero density there
            # (e.g. transmission through glass), so BSDF keeps weight 1.
            p_l = jnp.where(vm.dot(d, prev_n) >= 0.0, p_l, 0.0)
            # Sanitize BEFORE the ratio, not just select after: delta
            # lobes carry prev_pdf=inf and inf^2/inf^2 = NaN in the
            # UNSELECTED where-branch, which poisons reverse-mode
            # gradients through the select (the classic where-NaN-VJP
            # trap; measured as NaN d(loss)/d(alpha) under mis).
            pp_s = jnp.where(no_compete | ~jnp.isfinite(prev_pdf),
                             1.0, prev_pdf)
            pl_s = jnp.where(no_compete | ~jnp.isfinite(p_l), 0.0, p_l)
            w_emit = jnp.where(
                no_compete, 1.0,
                pp_s * pp_s / jnp.maximum(pp_s * pp_s + pl_s * pl_s, 1e-20))

            add_emit = alive & emissive_hit
            L = L + jnp.where(add_emit[:, None], beta * emitted * w_emit[:, None], 0.0)
            p_env = env_pdf(scene, d, prev_n)
            pe_s = jnp.where(no_compete | ~jnp.isfinite(p_env), 0.0, p_env)
            w_env = jnp.where(
                no_compete, 1.0,
                pp_s * pp_s / jnp.maximum(pp_s * pp_s + pe_s * pe_s, 1e-20))

            add_env = alive & miss
            L = L + jnp.where(add_env[:, None], beta * env_li * w_env[:, None], 0.0)
        else:
            add_cond = alive & ((bounce == 0) | prev_sg)
            add_emit = add_cond & emissive_hit
            L = L + jnp.where(add_emit[:, None], beta * emitted, 0.0)
            add_env = add_cond & miss
            L = L + jnp.where(add_env[:, None], beta * env_li, 0.0)
        # good_paths++ on emissive add AND on every counted escape, black or
        # not (trace.h:427-444 quirk).
        good = good + (add_emit | add_env).astype(jnp.int32)

        # ---- termination (trace.h:459)
        cont = alive & hit.hit_mask & ~emissive_hit & (bounce < max_depth)

        # ---- shading frame (computeLocalBasis, trace.h:132-146)
        # Miss lanes carry a zero hit normal; build their frame from a
        # fixed +z instead — every consumer is hit-masked, but garbage
        # frames NaN reverse mode through the masked branches (0-cotangent
        # times a NaN partial is NaN; sanitizing inputs is the only cure).
        safe_n = jnp.where(hit.hit_mask[:, None], hit.normal,
                           jnp.array([0.0, 0.0, 1.0], hit.normal.dtype))
        safe_dpdu = jnp.where(hit.hit_mask[:, None], hit.dpdu,
                              jnp.array([1.0, 0.0, 0.0], hit.dpdu.dtype))
        ft, fb, fn = vm.make_shading_frame(safe_n, safe_dpdu)
        # Normal mapping (getSmoothTriangleShadeRec, shapes/triangle.cpp:
        # 270-292; matte-only per Material_hasNormalMap, materials.cpp:190-204).
        # Deviation: texels are remapped 2c-1 to tangent-space normals — the
        # reference feeds raw [0,1] texels into the frame transform.
        if scene.textures.texels.shape[0] > 1:
            from craytracer_tpu.bsdf.texture import tex_lookup_nearest

            ntex = mp.normal_tex
            tex_n = tex_lookup_nearest(scene.textures, ntex, hit.uv) * 2.0 - 1.0
            n_pert = vm.normalize(vm.to_world(tex_n, ft, fb, fn))
            use_nm = (ntex >= 0) & (mat_type == T.MAT_MATTE)
            n_new = jnp.where(use_nm[:, None], n_pert, fn)
            ft, fb, fn = vm.make_shading_frame(n_new, hit.dpdu)
        wo_world = -d
        wo_local = vm.to_local(wo_world, ft, fb, fn)

        # ---- per-bounce uniforms: ONE fused 9-dim RNG call, sliced per
        # call site (bit-identical to separate calls — dims are a shared
        # arange). Layout: _DIM_LIGHT..=_DIM_RR above.
        # per-lane spp (spp-batched dispatch) must ride the lane
        # permutation: after stream compaction the state holds a
        # reordered half-width lane set, so index the closure's full-size
        # spp array by each lane's ORIGINAL id (state's `lane`)
        spp_l = (spp_index if jnp.ndim(spp_index) == 0
                 else jnp.take(spp_index, lane))
        u_all = uniforms(seed, pix, spp_l, bounce, 9, 0)

        # ---- NEE (trace.h:466-481)
        u_light = u_all[:, _DIM_LIGHT:_DIM_LIGHT + 2]
        u_pick = u_all[:, _DIM_PICK]
        if mis:
            from craytracer_tpu.bsdf import bsdf_f_nodelta, bsdf_pdf_balanced

            nee_mat = ~(
                (mat_type == T.MAT_MIRROR) | (mat_type == T.MAT_TRANSPARENT)
            )
        else:
            nee_mat = ~(
                (mat_type == T.MAT_MIRROR)
                | (mat_type == T.MAT_TRANSPARENT)
                | (mat_type == T.MAT_GLASS)
            )
        ls = sample_one_light(scene, u_pick, u_light, hit.point, fn, ft, fb)
        wi_l = vm.to_local(ls.wi, ft, fb, fn)
        # Lanes with no hit or no valid light sample carry garbage wi/
        # frames; their f_nee is never USED (want_shadow masks it) but a
        # NaN produced inside bsdf_f_nodelta's backward still reaches
        # d/d(material params) through the 0-cotangent product (0*NaN).
        # Sanitize the INPUT (a post-hoc where cannot help reverse mode).
        _nee_ok = ls.valid & hit.hit_mask
        wi_l = jnp.where(_nee_ok[:, None],
                         wi_l, jnp.array([0.0, 0.0, 1.0], wi_l.dtype))
        if mis:
            f_nee = bsdf_f_nodelta(wi_l, wo_local, mp, present=present) * jnp.abs(vm.dot(fn, ls.wi))[:, None]
        else:
            # Reference quirk, image-visible: BSDF_f computes local frames
            # and then passes the WORLD vectors into the lobe formulas
            # anyway (reflection.cpp:719-735) — so Oren-Nayar / FresnelBlend
            # NEE terms use world-space cosines. Constant for Lambertian
            # (sigma=0), visibly different for sigma!=0 and plastic
            # (verified against the headless reference binary on
            # scenes/parity_mix.txt).
            f_nee = bsdf_f_direct(ls.wi, wo_world, mp, present=present) * jnp.abs(vm.dot(fn, ls.wi))[:, None]
        want_shadow = (cont & nee_mat & ls.valid
                       & ((f_nee[:, 0] > 0.0) | (f_nee[:, 1] > 0.0)
                          | (f_nee[:, 2] > 0.0)))
        shadow_o = _offset_ray(hit.point, hit.normal, ls.wi)
        # The offset origin sits closer to the light along wi; compare the
        # occluder distance against the OFFSET-ADJUSTED light distance, or
        # a sample on the light's own surface registers as an occluder
        # when the light is nearer than ~offset/1e-3 (seen as a dark
        # ceiling above the cornell lamp).
        dist_adj = ls.distance - vm.dot(shadow_o - hit.point, ls.wi)
        # Lanes that won't use the result shoot an ESCAPE ray (origin far
        # outside every scene box, max_dist 0) instead of a stale one:
        # `lit` is masked by want_shadow, but the traversal still pays for
        # whatever ray sits in the lane — block-synchronous accels
        # (binned/pallas) pay the block UNION, so stale rays from retired
        # lanes would widen every remaining round for free.
        shadow_o = jnp.where(want_shadow[:, None], shadow_o, 3.0e18)
        dist_adj_t = jnp.where(want_shadow, dist_adj, 0.0)
        t_shadow = shadow_distance(scene, shadow_o, ls.wi, dist_adj_t)
        if geom_axis is not None:
            t_shadow = jax.lax.pmin(t_shadow, geom_axis)
        lit = t_shadow >= dist_adj - jnp.maximum(K_EPSILON, 1e-3 * dist_adj)
        nee_scale = f_nee * ls.li / jnp.maximum(ls.pdf, 1e-12)[:, None]
        if mis:
            # power heuristic vs the BSDF strategy; delta lights keep w=1
            ltype_l = jnp.take(scene.lights.light_type, jnp.clip(
                jnp.searchsorted(scene.lights.power_cdf, u_pick, side="right"),
                0, scene.lights.light_type.shape[0] - 1)) if scene.lights.light_type.shape[0] else jnp.zeros_like(hit.mat_id)
            is_delta_l = (ltype_l == T.LIGHT_DIRECTIONAL) | (ltype_l == T.LIGHT_POINT)
            # same where-NaN-VJP guard as w_emit, applied to the INPUT:
            # degenerate NEE samples (invalid lanes carry wi ~ 0) NaN the
            # half-vector normalize inside the pdf, and a post-hoc select
            # cannot stop reverse mode from pulling that NaN into
            # d/d(alpha) — sanitize wi before the primal instead.
            skip_w = is_delta_l | ~want_shadow
            up = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], wi_l.dtype),
                                  wi_l.shape)
            wi_l_s = jnp.where(skip_w[:, None], up, wi_l)
            p_b = bsdf_pdf_balanced(wi_l_s, wo_local, mp, present=present)
            pb_s = jnp.where(skip_w | ~jnp.isfinite(p_b), 0.0, p_b)
            pl2_s = jnp.where(skip_w, 1.0, ls.pdf)
            w_l = jnp.where(
                is_delta_l, 1.0,
                pl2_s * pl2_s / jnp.maximum(pl2_s * pl2_s + pb_s * pb_s,
                                            1e-20))

            nee_scale = nee_scale * w_l[:, None]
        contrib = jnp.where(
            (want_shadow & lit)[:, None],
            beta * nee_scale,
            0.0,
        )
        L = L + contrib
        good = good + ((contrib[:, 0] != 0.0) | (contrib[:, 1] != 0.0)
                       | (contrib[:, 2] != 0.0)).astype(jnp.int32)

        # ---- BSDF sampling (trace.h:484-496)
        u_bsdf = u_all[:, _DIM_BSDF:_DIM_BSDF + 3]
        f_s, wi_local, pdf_s, is_spec, is_glossy = bsdf_sample(
            u_bsdf, wo_local, mp, balanced=mis, present=present)
        # non-finite sampled pdfs (grazing microfacet denominators) are
        # dead samples; leaving inf in pdf_s NaNs reverse mode through
        # every later use (prev_pdf MIS weights) even where-masked
        pdf_s = jnp.where(jnp.isfinite(pdf_s), pdf_s, 0.0)
        dead_sample = (pdf_s <= 0.0) | ((f_s[:, 0] == 0.0) & (f_s[:, 1] == 0.0)
                                        & (f_s[:, 2] == 0.0))
        wi_world = vm.to_world(wi_local, ft, fb, fn)
        weight = f_s * (jnp.abs(vm.dot(wi_world, fn)) / jnp.maximum(pdf_s, 1e-12))[:, None]
        new_beta = jnp.where(cont[:, None], beta * weight, beta)

        # ---- Russian roulette (trace.h:512-525)
        u_rr = u_all[:, _DIM_RR]
        max_comp = vm.max3(new_beta)
        q = jnp.maximum(0.05, 1.0 - max_comp)
        rr_active = cont & (bounce > rr_start)
        rr_kill = rr_active & (u_rr < q)
        new_beta = jnp.where(
            (rr_active & ~rr_kill)[:, None],
            new_beta / jnp.maximum(1.0 - q, 1e-6)[:, None],
            new_beta,
        )

        new_alive = cont & ~dead_sample & ~rr_kill
        # Retired lanes carry an ESCAPE ray (far origin: every box test
        # fails on the first round) instead of re-traversing their stale
        # ray each remaining bounce — results are alive-masked either
        # way, so the image is bit-identical; the traversal work isn't.
        new_o = jnp.where(new_alive[:, None],
                          _offset_ray(hit.point, hit.normal, wi_world),
                          3.0e18)
        # +x from a (+3e18)^3 origin: every box is behind the ray
        new_d = jnp.where(new_alive[:, None], wi_world,
                          jnp.array([1.0, 0.0, 0.0], d.dtype))
        new_prev_sg = jnp.where(cont, is_spec | is_glossy, prev_sg)
        new_prev_pdf = jnp.where(cont, pdf_s, prev_pdf)
        new_prev_delta = jnp.where(cont, is_spec, prev_delta)
        new_prev_n = jnp.where(cont[:, None], fn, prev_n)
        n_live = jnp.sum(alive.astype(jnp.int32))
        rays = rays + n_live
        shadows = shadows + jnp.sum(want_shadow.astype(jnp.int32))
        # .add, not .set: after compaction a bounce runs as two half-width
        # phases that must sum into the same histogram slot
        live_hist = live_hist.at[bounce].add(n_live)
        # per-bounce log record (SampleLog, trace.h:176-219)
        aux = {
            "t": hit.t,
            "beta": beta,
            "emissive_indirect_contrib": jnp.where(add_emit[:, None], beta * emitted, 0.0),
            "env_indirect_contrib": jnp.where(add_env[:, None], beta * env_li, 0.0),
            "direct_contrib": contrib,
            "new_sample_pdf": pdf_s,
            "alive": alive,
        }
        return (new_o, new_d, new_beta, L, good, new_alive, new_prev_sg,
                rays, shadows, live_hist, new_prev_pdf, new_prev_delta,
                new_prev_n, pix, lane), aux

    return step


# state-tuple indices of per-LANE arrays (everything except the counters
# at indices 7, 8, 9) — used by the compaction permute
_LANE_IDX = (0, 1, 2, 3, 4, 5, 6, 10, 11, 12, 13, 14)


def _init_state(origin, direction, max_depth, pixel_ids):
    n = origin.shape[0]
    f32 = origin.dtype
    return (
        origin,
        direction,
        jnp.ones((n, 3), f32),
        jnp.zeros((n, 3), f32),
        jnp.zeros((n,), jnp.int32),
        jnp.ones((n,), bool),
        jnp.zeros((n,), bool),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((max_depth + 1,), jnp.int32),
        jnp.zeros((n,), f32),  # prev bsdf pdf (MIS)
        jnp.ones((n,), bool),  # prev lobe was delta (MIS; true at start)
        jnp.zeros((n, 3), f32).at[:, 2].set(1.0),  # prev shading normal
        jnp.asarray(pixel_ids, jnp.int32),  # per-lane pixel (RNG counter)
        jnp.arange(n, dtype=jnp.int32),  # original lane id (scatter-back)
    )


def trace_paths(scene: T.Scene, origin, direction, seed, pixel_ids, spp_index,
                max_depth: int, rr_start: int = 3, with_metrics: bool = False,
                mis: bool = False, remat: bool = False, compact_at: int = 0,
                geom_axis: str | None = None, tri_base=None,
                fast_shade=False, interpret: bool = False):
    """Trace one path per lane. Returns (L[N,3], good_paths[N] int32), plus a
    metrics dict {rays, shadow_rays, bounce_live[depth+1]} when
    `with_metrics` (the on-device counter buffers standing in for the
    reference's global intersect counters, intersect.h:363-364).

    `remat=True` checkpoints each bounce (jax.checkpoint): the backward pass
    re-runs the bounce instead of storing its intermediates — trading FLOPs
    for HBM so large inverse renders fit (SURVEY.md §7 step 7
    "recomputation-vs-storage of per-bounce records").

    `compact_at=B` (B > 0) enables STREAM COMPACTION (the north star's
    wavefront-queue compaction; SURVEY.md §7 "mask-based liveness +
    periodic stream compaction"): after bounce B-1 the lanes are permuted
    alive-first with one fused gather and the remaining bounces run on the
    FIRST HALF only; a lax.cond processes the overflow half only when any
    of its lanes survived — Russian roulette (trace.h:512-525) makes that
    rare, so deep tails cost half width. Unbiased by construction (every
    alive lane is still traced; results scatter back by lane id).

    `fast_shade="bounce"` runs the whole-pass megakernel
    (integrator/pallas_shade.py) where it applies; `interpret=True` runs
    it in the Pallas interpreter (tests on the CPU)."""
    if fast_shade and mis:
        raise ValueError("fast_shade covers the reference estimator only")
    # The megakernel has no VJP (remat exists for gradients), cannot see
    # the cross-shard hit reduction of geometry sharding, and packs the
    # alive-per-bounce bitmask into an i32 (depth < 31); those cases run
    # the XLA bounce step.
    if (fast_shade == "bounce" and geom_axis is None and not remat
            and max_depth < 31 and scene.tri_cam is None):
        # ---- whole-PASS megakernel: for brute-force scenes the ENTIRE
        # bounce loop is one kernel launch — path state never round-trips
        # device memory between bounces. Dense by construction, so
        # compact_at is moot here.
        from craytracer_tpu.integrator.pallas_shade import fused_pass

        L, good, m = fused_pass(
            scene, origin, direction,
            jnp.asarray(pixel_ids, jnp.int32), spp_index, seed,
            max_depth, rr_start, interpret=interpret)
        if with_metrics:
            return L, good, m
        return L, good
    step = _make_bounce_step(scene, seed, spp_index, max_depth,
                             rr_start, mis=mis, geom_axis=geom_axis,
                             tri_base=tri_base)

    if remat:
        ckpt = jax.checkpoint(lambda b, st: step(b, st)[0])

        def body(bounce, state):
            return ckpt(bounce, state)
    else:
        def body(bounce, state):
            return step(bounce, state)[0]

    n = origin.shape[0]
    state0 = _init_state(origin, direction, max_depth, pixel_ids)

    # Bounce-0 peel: when the scene carries a camera-bounce accel
    # (tri_cam), the first bounce runs OUTSIDE the fori_loop with the
    # coherent-tile traversal; bounces 1.. keep the loop body. The peel
    # costs one extra trace of the step at compile time.
    first_bounce = 0
    if scene.tri_cam is not None:
        if remat:
            ckpt0 = jax.checkpoint(lambda st: step(0, st, cam0=True)[0])
            state0 = ckpt0(state0)
        else:
            state0 = step(0, state0, cam0=True)[0]
        first_bounce = 1

    if not compact_at or compact_at > max_depth or n < 2:
        import os as _os_dbg
        if _os_dbg.environ.get("CRAY_UNROLL_BOUNCES") == "1":
            # debug aid: python-unrolled bounce loop so JAX_DEBUG_NANS /
            # tracebacks point INTO a bounce instead of at the fori_loop
            state = state0
            for _b in range(first_bounce, max_depth + 1):
                state = body(_b, state)
        else:
            state = jax.lax.fori_loop(first_bounce, max_depth + 1, body,
                                      state0)
        L, good = state[3], state[4]
    else:
        from craytracer_tpu.ops.gather import take_rows

        state = jax.lax.fori_loop(first_bounce, compact_at, body, state0)
        alive = state[5]
        order = jnp.argsort(~alive, stable=True)  # alive lanes first
        permuted = take_rows(order, tuple(state[i] for i in _LANE_IDX))
        lanes = list(state)
        for k, i in enumerate(_LANE_IDX):
            lanes[i] = permuted[k]
        state = tuple(lanes)

        half = n // 2

        def run_tail(sub_state, counters):
            full = list(sub_state[:7]) + list(counters) + list(sub_state[7:])
            full = jax.lax.fori_loop(compact_at, max_depth + 1, body,
                                     tuple(full))
            return (tuple(full[i] for i in _LANE_IDX),
                    (full[7], full[8], full[9]))

        def split(sl):
            return tuple(state[i][sl] for i in _LANE_IDX)

        counters = (state[7], state[8], state[9])
        lo, counters = run_tail(split(jnp.s_[:half]), counters)
        hi = split(jnp.s_[half:])

        def do_hi(args):
            hi, counters = args
            return run_tail(hi, counters)

        hi, counters = jax.lax.cond(
            jnp.any(hi[5]),  # index 5 of _LANE_IDX order == alive? see note
            do_hi, lambda args: args, (hi, counters))

        merged = [jnp.concatenate([a, b], axis=0) for a, b in zip(lo, hi)]
        # scatter back to input lane order
        lane = merged[-1]
        L = jnp.zeros((n, 3), origin.dtype).at[lane].set(merged[3])
        good = jnp.zeros((n,), jnp.int32).at[lane].set(merged[4])
        state = list(state0)
        state[7], state[8], state[9] = counters

    rays, shadows, live_hist = state[7], state[8], state[9]
    if with_metrics:
        return L, good, {"rays": rays, "shadow_rays": shadows,
                         "bounce_live": live_hist}
    return L, good


def trace_paths_logged(scene: T.Scene, origin, direction, seed, pixel_ids,
                       spp_index, max_depth: int, rr_start: int = 3):
    """Debug tracer: the exact same bounce step, unrolled, returning the
    per-bounce sample log — the wavefront form of `pathTraceLogging` +
    SampleLog (trace.h:176-219, 535-684), used to diagnose NaN/Inf paths.

    Returns (L, good, log) where log maps each SampleLog field to a
    [max_depth+1, N, ...] array."""
    step = _make_bounce_step(scene, seed, spp_index, max_depth, rr_start)
    state = _init_state(origin, direction, max_depth, pixel_ids)
    logs = []
    for bounce in range(max_depth + 1):
        state, aux = step(bounce, state)
        logs.append(aux)
    L, good = state[3], state[4]
    log = {k: jnp.stack([a[k] for a in logs]) for k in logs[0]}
    return L, good, log


def render_sample(scene: T.Scene, camera, film, pixel_ids, seed, spp_index,
                  max_depth: int, estimator: str = "reference",
                  trace_type: str = "PATHTRACE", sampler=None,
                  geom_axis: str | None = None, tri_base=None,
                  fast_shade=False, interpret: bool = False):
    """One progressive pass: raygen + trace.

    estimator="reference": L / max(good_paths, 1) — the reference's
    contributing-event normalization (trace.h:528-529), for image parity.
    estimator="physical": plain L — the standard unbiased NEE estimator
    (kept behind a flag per SURVEY.md §6 hardest-parts note).
    trace_type: PATHTRACE | WHITTED | RAYCAST (config.h trace_type).
    sampler: optional sampling.tables.SampleTable — the reference's
    table-driven sample sets (regular / multijittered / Hammersley,
    sampling.cpp:169-352) applied to the film-jitter dimension.
    fast_shade: "bounce" takes the whole-pass megakernel where it applies
    (pallas_shade.production_fast_shade decides); `interpret=True` runs it
    in the Pallas interpreter (tests on the CPU)."""
    from craytracer_tpu.camera import generate_rays
    from craytracer_tpu.sampling.multijitter import stratified_jitter

    from craytracer_tpu.camera import PINHOLE, THINLENS

    if (fast_shade == "bounce" and sampler is None
            and trace_type == "PATHTRACE" and estimator != "mis"
            and geom_axis is None and scene.tri_cam is None
            and camera.camera_type in (PINHOLE, THINLENS)
            and max_depth < 31
            and film.width * film.height <= (1 << 24)):
        # (2^24 pixel cap: the in-kernel raygen derives row/col in f32,
        # exact only while pixel ids are; 31-depth cap: see trace_paths)
        # Fully-fused pass: raygen (stratified jitter + pinhole math)
        # joins the megakernel — the launch consumes only pixel ids.
        from craytracer_tpu.integrator.pallas_shade import fused_pass

        L, good, _m = fused_pass(
            scene, None, None, jnp.asarray(pixel_ids, jnp.int32),
            spp_index, seed, max_depth, raygen="strat", camera=camera,
            film=film, width=int(film.width), interpret=interpret)
        if estimator == "physical":
            return L
        norm = jnp.where(good > 0,
                         1.0 / jnp.maximum(good, 1).astype(L.dtype), 0.0)
        return L * norm[:, None]

    if sampler is not None:
        from craytracer_tpu.sampling.tables import table_sample

        jitter = table_sample(sampler, seed, pixel_ids, spp_index, dim=0)
    else:
        # Stratified film jitter — the counter-RNG form of the reference's
        # multijittered pixel sampling (sampling.cpp:260-352).
        jitter = stratified_jitter(seed, pixel_ids, spp_index)
    lens_u = uniforms(seed, pixel_ids, spp_index, CAMERA_BOUNCE, 2, 2)
    o, d = generate_rays(camera, film, pixel_ids, jitter, lens_u)
    if trace_type in ("WHITTED", "RAYCAST"):
        from craytracer_tpu.integrator.whitted import trace_whitted

        return trace_whitted(scene, o, d, seed, pixel_ids, spp_index, max_depth,
                             specular_continuation=(trace_type == "WHITTED"))
    # Deep traces compact after Russian roulette starts killing lanes
    # (trace.h:512-525 creates the holes). Compaction pays only when the
    # per-bounce cost is traversal-dominated; on brute-force scenes the
    # permute costs more than the half-width tail saves. So deep
    # accel-backed triangle scenes compact at 2; everything else runs
    # dense. (Not yet re-measured on the GPU.)
    n_tris = scene.triangles.mat_id.shape[0]
    compact_at = 2 if (max_depth >= 8 and scene.accel != "none"
                       and n_tris >= 4096) else 0
    L, good = trace_paths(scene, o, d, seed, pixel_ids, spp_index, max_depth,
                          mis=(estimator == "mis"), compact_at=compact_at,
                          geom_axis=geom_axis, tri_base=tri_base,
                          fast_shade=fast_shade, interpret=interpret)
    if estimator in ("physical", "mis"):
        return L
    norm = jnp.where(good > 0, 1.0 / jnp.maximum(good, 1).astype(L.dtype), 0.0)
    return L * norm[:, None]
