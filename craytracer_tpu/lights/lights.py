"""Light sampling for next-event estimation, vectorized over hit queues.

Re-implements `uniformSampleOneLight` + `estimateDirect`
(trace.h:221-397) as one masked computation over the light table:

* light selection by normalized-power CDF — the scalar walk at
  trace.h:371-391 becomes a `searchsorted`;
* per-type surface sampling (rect / sphere / disk / env,
  trace.h:230-314) runs masked for every lane;
* area -> solid-angle pdf conversion and the facing rejections
  (trace.h:316-323) follow the reference exactly.

The caller (integrator) fires the shadow ray; this module returns the
candidate sample so traversal stays a separate wavefront stage.
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax.numpy as jnp

from craytracer_tpu.constants import INV_PI, JITTERED_UP, PI, TMAX, TWO_PI
from craytracer_tpu.core import math as vm
from craytracer_tpu.sampling.mappings import map_to_disk_polar, map_to_hemisphere_cosine
from craytracer_tpu.scene import types as T


@struct.dataclass
class LightSample:
    wi: jnp.ndarray  # [N, 3] direction to the light sample
    li: jnp.ndarray  # [N, 3] incident radiance
    distance: jnp.ndarray  # [N] shadow-ray length
    pdf: jnp.ndarray  # [N] solid-angle-converted pdf * pick probability
    valid: jnp.ndarray  # [N] facing/pdf checks passed


def env_radiance(env: T.EnvLight, textures: T.TexturePack, direction):
    """getEnvLightIncRadiance (lights.cpp:233-248). `direction` is already
    transformed by env.transform where the reference does so."""
    if env.kind == 0:
        return jnp.zeros_like(direction)
    if env.kind == 1:
        return jnp.broadcast_to(env.color * env.intensity, direction.shape)
    from craytracer_tpu.bsdf.texture import tex_lookup_nearest

    theta, phi = vm.cartesian_to_spherical(direction)
    u, v = vm.spherical_to_uv(theta, phi)
    uv = jnp.stack([u, v], axis=-1)
    tid = jnp.broadcast_to(env.tex_id, direction.shape[:-1])
    texel = tex_lookup_nearest(textures, tid, uv)
    return texel * env.intensity


def light_pdf_for_hit(scene: T.Scene, hit_group, hit_prim, hit_point,
                      prev_point, wi, hit_normal=None):
    """MIS: density (solid angle x pick probability) with which
    `sample_one_light` from `prev_point` would have produced direction `wi`
    landing on the emissive primitive (hit_group, hit_prim). 0 when the hit
    is not a NEE-selectable light."""
    lights = scene.lights
    L = lights.light_type.shape[0]
    if L == 0:
        return jnp.zeros(hit_group.shape, hit_point.dtype)
    match = (lights.src_group[None, :] == hit_group[:, None]) & (
        lights.src_prim[None, :] == hit_prim[:, None])  # [N, L]
    idx = jnp.argmax(match, axis=1).astype(jnp.int32)
    found = jnp.any(match, axis=1)
    # emissive mesh triangles map through tri_light_id
    ml = scene.mesh_lights
    if ml.surface_area.shape[0] > 0:
        tri_lid = jnp.take(ml.tri_light_id,
                           jnp.clip(hit_prim, 0, ml.tri_light_id.shape[0] - 1))
        mesh_found = (hit_group == T.GROUP_TRIANGLE) & (tri_lid >= 0)
        idx = jnp.where(mesh_found, jnp.maximum(tri_lid, 0), idx)
        found = found | mesh_found

    from craytracer_tpu.ops.gather import take_rows

    ltype, p0, v1, v2, lnormal, radius, pick_p, mlid_raw = take_rows(
        idx, (lights.light_type, lights.p0, lights.v1, lights.v2,
              lights.normal, lights.radius, lights.power,
              lights.mesh_light_id))

    present = scene.light_types_present or None

    def use(*codes):
        return present is None or any(c in present for c in codes)

    # per-type area density at the hit point (estimateDirect's sampling);
    # statically absent light types compile away (see sample_light_index)
    pdf_area = jnp.zeros(hit_group.shape, hit_point.dtype)
    sn = lnormal
    if use(T.LIGHT_AREA_RECT):
        pdf_rect = 1.0 / jnp.maximum(vm.length(v1) * vm.length(v2), 1e-12)
        pdf_area = jnp.where(ltype == T.LIGHT_AREA_RECT, pdf_rect, pdf_area)
    if use(T.LIGHT_AREA_SPHERE):
        n_s = vm.normalize(hit_point - p0)  # sphere surface normal at hit
        z_axis = vm.normalize(prev_point - p0)
        cos_local = jnp.maximum(vm.dot(n_s, z_axis), 0.0)
        pdf_sph = cos_local / jnp.maximum(2.0 * PI * PI * radius * radius, 1e-12)
        pdf_area = jnp.where(ltype == T.LIGHT_AREA_SPHERE, pdf_sph, pdf_area)
        sn = jnp.where((ltype == T.LIGHT_AREA_SPHERE)[:, None], n_s, sn)
    if use(T.LIGHT_AREA_DISK):
        pdf_dsk = 1.0 / (PI * jnp.maximum(radius * radius, 1e-12))
        pdf_area = jnp.where(ltype == T.LIGHT_AREA_DISK, pdf_dsk, pdf_area)
    mlid2 = jnp.maximum(mlid_raw, 0)
    if scene.mesh_lights.surface_area.shape[0] > 0 and use(T.LIGHT_MESH):
        pdf_msh = 1.0 / jnp.maximum(
            jnp.take(scene.mesh_lights.surface_area, mlid2), 1e-9)
        pdf_area = jnp.where(ltype == T.LIGHT_MESH, pdf_msh, pdf_area)

    is_mesh = ltype == T.LIGHT_MESH
    if hit_normal is not None:
        sn = jnp.where(is_mesh[:, None], hit_normal, sn)
    to_hit = hit_point - prev_point
    dist2 = vm.length_sq(to_hit)
    # SIGNED cosine for one-sided area lights: sample_one_light rejects
    # samples with dot(to_sample, sn) > 0, i.e. the light strategy has
    # ZERO density on the back side — the BSDF strategy must keep weight 1
    # there or back-facing emission (reference emissives emit both sides)
    # loses energy in MIS mode. Mesh lights keep |cos| (their NEE samples
    # by area over the whole soup with the hit normal as orientation).
    cos_signed = vm.dot(sn, -wi)
    cos_l = jnp.where(is_mesh, jnp.abs(cos_signed), cos_signed)
    pdf_sa = pdf_area * dist2 / jnp.maximum(cos_l, 1e-6)
    return jnp.where(found & (cos_l > 0.0), pdf_sa * pick_p, 0.0)


def env_pdf(scene: T.Scene, wi, prev_normal):
    """MIS: density of the env-light NEE strategy for escape direction `wi`
    from a vertex with shading normal `prev_normal` (cosine-hemisphere,
    trace.h:272-296), times the env light's pick probability."""
    lights = scene.lights
    if lights.light_type.shape[0] == 0 or scene.env.kind == 0:
        return jnp.zeros(wi.shape[:-1], wi.dtype)
    env_pick = jnp.sum(jnp.where(lights.light_type == T.LIGHT_ENV, lights.power, 0.0))
    # invert the env transform (rotation): the cosine sample was drawn about
    # the shading normal then rotated
    if scene.env.importance:
        # importance mode: density of the texel-CDF strategy for wi —
        # lookup direction = transform @ wi (the escape-path convention)
        from craytracer_tpu.bsdf.texture import nearest_texel_xy

        H, W = scene.env.imp_h, scene.env.imp_w
        d_look = vm.mat3_apply(scene.env.transform, wi)
        theta, phi = vm.cartesian_to_spherical(d_look)
        u, v = vm.spherical_to_uv(theta, phi)
        # SAME texel addressing as the radiance lookup/sampler (reference
        # getTexColor round-half + v flip), so the density follows the
        # texel whose radiance the direction actually sees.
        x, y = nearest_texel_xy(jnp.int32(W), jnp.int32(H), u, v)
        p_tex = jnp.take(scene.env.flat_pdf, y * W + x)
        omega = (TWO_PI / W) * (PI / H) * jnp.maximum(jnp.sin(theta), 1e-6)
        # The NEE sampler rejects below-horizon draws (reject_env), so the
        # strategy never contributes there — report zero density to match,
        # or MIS down-weights escape rays by a strategy that can't fire.
        facing = vm.dot(wi, prev_normal) >= 0.0
        return jnp.where(facing, p_tex / omega * env_pick, 0.0)
    wi_local = vm.mat3_apply(scene.env.transform.T, wi)
    cos_t = jnp.maximum(vm.dot(wi_local, prev_normal), 0.0)
    return cos_t * INV_PI * env_pick


def sample_one_light(scene: T.Scene, u_pick, u2, hit_point, shading_normal,
                     frame_t, frame_b) -> LightSample:
    """Pick one light by the power CDF and sample a point on it.

    Returns pdf already divided through by the pick probability
    (uniformSampleOneLight's final 1/light_pdf scale, trace.h:393-396),
    i.e. contribution = f * |cos| * li / pdf after the shadow test.
    """
    lights = scene.lights
    n = hit_point.shape[0]
    num_lights = lights.light_type.shape[0]
    if num_lights == 0:
        z = jnp.zeros((n,), hit_point.dtype)
        return LightSample(wi=jnp.zeros_like(hit_point), li=jnp.zeros_like(hit_point),
                           distance=z, pdf=z, valid=jnp.zeros((n,), bool))

    idx = jnp.clip(
        jnp.searchsorted(lights.power_cdf, u_pick, side="right"), 0, num_lights - 1
    ).astype(jnp.int32)
    pick_p = jnp.take(lights.power, idx)
    ls = sample_light_index(scene, idx, u2, hit_point, shading_normal,
                            frame_t, frame_b)
    # Fold in the pick probability (uniformSampleOneLight, trace.h:396).
    return ls.replace(pdf=ls.pdf * jnp.maximum(pick_p, 1e-12),
                      valid=ls.valid & (pick_p > 0.0))


def sample_light_index(scene: T.Scene, idx, u2, hit_point, shading_normal,
                       frame_t, frame_b) -> LightSample:
    """Sample light `idx` ([N] int32) for every lane — the estimateDirect
    per-type sampling block (trace.h:230-314) plus the delta lights
    (directional/point, Light_sample_Li-style lights.cpp:309-327) which the
    reference reserves for its raycast/whitted modes.

    Light types statically absent from the scene (scene.light_types_present)
    compile to nothing — the light-table analog of the BSDF lobe gate
    (bsdf/bxdf.py _use): a rect-only Cornell pays zero sphere/disk/env/mesh
    sampling work per bounce."""
    lights = scene.lights
    present = scene.light_types_present or None

    def use(*codes):
        return present is None or any(c in present for c in codes)

    from craytracer_tpu.ops.gather import take_rows

    (ltype, p0, v1, v2, lnormal, radius, color, intensity,
     mlid_raw) = take_rows(
        idx, (lights.light_type, lights.p0, lights.v1, lights.v2,
              lights.normal, lights.radius, lights.color, lights.intensity,
              lights.mesh_light_id))

    zero3 = jnp.zeros_like(hit_point)
    zero1 = jnp.zeros(hit_point.shape[:-1], hit_point.dtype)
    sp, sn, pdf_area = zero3, zero3, zero1

    if use(T.LIGHT_AREA_RECT):
        # ---- RECT (trace.h:244-254): uniform point, pdf = 1/(|w||h|)
        sp_rect = p0 + u2[:, 0:1] * v1 + u2[:, 1:2] * v2
        pdf_rect = 1.0 / jnp.maximum(vm.length(v1) * vm.length(v2), 1e-12)
        is_rect = ltype == T.LIGHT_AREA_RECT
        sp = jnp.where(is_rect[:, None], sp_rect, sp)
        sn = jnp.where(is_rect[:, None], lnormal, sn)
        pdf_area = jnp.where(is_rect, pdf_rect, pdf_area)

    if use(T.LIGHT_AREA_SPHERE):
        # ---- SPHERE (trace.h:230-243): cosine-hemisphere about the axis
        # from center to the shading point; pdf = cos/(2 pi^2 r^2) per the
        # reference's expression 1/(2 pi r^2) * |h.z| * INV_PI.
        z_axis = vm.normalize(hit_point - p0)
        zt, zb, _ = vm.orthonormal_basis(z_axis)
        h = map_to_hemisphere_cosine(u2)
        h_world = vm.to_world(h, zt, zb, z_axis)
        sp_sph = p0 + h_world * radius[:, None]
        pdf_sph = (
            1.0 / (2.0 * PI * jnp.maximum(radius * radius, 1e-12))
            * vm.abs_cos_theta(h)
            * INV_PI
        )
        is_sph = ltype == T.LIGHT_AREA_SPHERE
        sp = jnp.where(is_sph[:, None], sp_sph, sp)
        sn = jnp.where(is_sph[:, None], h_world, sn)
        pdf_area = jnp.where(is_sph, pdf_sph, pdf_area)

    if use(T.LIGHT_AREA_DISK):
        # ---- DISK (trace.h:255-270): polar disk map in the
        # (JITTERED_UP x n) basis; pdf = 1/(pi r^2).
        jup = jnp.asarray(JITTERED_UP, hit_point.dtype)
        x_axis = vm.normalize(vm.cross(jnp.broadcast_to(jup, lnormal.shape), lnormal))
        y_axis = vm.cross(x_axis, lnormal)
        dsk = map_to_disk_polar(u2)
        sp_dsk = p0 + (dsk[:, 0:1] * x_axis + dsk[:, 1:2] * y_axis) * radius[:, None]
        pdf_dsk = 1.0 / (PI * jnp.maximum(radius * radius, 1e-12))
        is_dsk = ltype == T.LIGHT_AREA_DISK
        sp = jnp.where(is_dsk[:, None], sp_dsk, sp)
        sn = jnp.where(is_dsk[:, None], lnormal, sn)
        pdf_area = jnp.where(is_dsk, pdf_dsk, pdf_area)

    if use(T.LIGHT_ENV):
        if scene.env.importance:
            # ---- ENV, texel importance sampling (beyond-reference,
            # EnvLight.flat_cdf): draw a lat-long texel ~ luminance x
            # sin(theta), jitter inside it (u reuses the CDF residual),
            # convert to a direction; pdf = p_texel / texel solid angle.
            # Consistent with the ESCAPE-path lookup (integrator
            # transforms the ray dir before lookup): the sampled lookup
            # direction maps to world through transform^T.
            H, W = scene.env.imp_h, scene.env.imp_w
            u_cdf = u2[:, 0]
            # `tix` = sampled env texel index (NOT the per-lane light
            # index `idx` this function was called with — keep distinct).
            tix = jnp.clip(jnp.searchsorted(scene.env.flat_cdf, u_cdf,
                                            side="right"), 0, H * W - 1)
            p_tex = jnp.take(scene.env.flat_pdf, tix)
            prev_cdf = jnp.where(tix > 0,
                                 jnp.take(scene.env.flat_cdf,
                                          jnp.maximum(tix - 1, 0)), 0.0)
            ju = jnp.clip((u_cdf - prev_cdf)
                          / jnp.maximum(p_tex, 1e-12), 0.0, 1.0)
            r = (tix // W).astype(u_cdf.dtype)
            c = (tix % W).astype(u_cdf.dtype)
            # Jitter inside texel (r, c)'s uv cell under the REFERENCE
            # texel addressing (getTexColor round-half + v flip,
            # bsdf/texture.py nearest_texel_xy): col c covers
            # u in [(c-.5)/W, (c+.5)/W) (phi periodic, mod 1), row r
            # covers v in [1-(r+.5)/H, 1-(r-.5)/H) (clipped at poles) —
            # so the sampled direction's radiance lookup lands on the
            # texel whose luminance drove the CDF.
            # Jitter inside texel (r, c)'s cell under the NET reference
            # mapping (sphericalToUV's v flip cancels getTexColor's:
            # image row r covers theta/pi * H in (r-.5, r+.5], col c
            # covers phi_ref/2pi * W in (c-.5, c+.5] mod W). Row 0 is the
            # round-mod wrap row owning slivers at BOTH poles: its
            # negative half wraps to theta near pi.
            u_ll = jnp.mod((c - 0.5 + ju) / W, 1.0)
            v_raw = (r - 0.5 + u2[:, 1]) / H
            v_ll = jnp.clip(jnp.where(v_raw < 0.0, 1.0 + v_raw, v_raw),
                            0.0, 1.0)
            theta = v_ll * PI
            # invert cartesian_to_spherical: phi_ref = atan2(z, x) + pi
            phi = u_ll * TWO_PI - PI
            st = jnp.sin(theta)
            d_look = jnp.stack([st * jnp.cos(phi), jnp.cos(theta),
                                st * jnp.sin(phi)], axis=-1)
            wi_env = vm.mat3_apply(scene.env.transform.T, d_look)
            li_env = env_radiance(scene.env, scene.textures, d_look)
            omega = (TWO_PI / W) * (PI / H) * jnp.maximum(st, 1e-6)
            pdf_env = p_tex / omega
            dist_env = jnp.broadcast_to(scene.env.world_radius,
                                        pdf_env.shape)
        else:
            # ---- ENV (trace.h:272-296): cosine hemisphere about the
            # shading normal, rotated by the env transform; pdf in solid
            # angle.
            h_env = map_to_hemisphere_cosine(u2)
            wi_env = vm.to_world(h_env, frame_t, frame_b, shading_normal)
            wi_env = vm.mat3_apply(scene.env.transform, wi_env)
            li_env = env_radiance(scene.env, scene.textures, wi_env)
            pdf_env = jnp.abs(vm.dot(wi_env, shading_normal)) * INV_PI
            dist_env = jnp.broadcast_to(scene.env.world_radius,
                                        pdf_env.shape)

    # ---- MESHLIGHT (MeshLight_genSample, lights.cpp:139-232): CDF binary
    # search over triangle areas + uniform barycentrics. The reference never
    # NEE-picks these (power 0); the principled power mode does.
    ml = scene.mesh_lights
    mlid = jnp.maximum(mlid_raw, 0)
    has_mesh = ml.tri_index.shape[0] > 0 and use(T.LIGHT_MESH)
    if has_mesh:
        start = jnp.take(ml.light_offset, mlid)
        end = jnp.take(ml.light_offset, jnp.minimum(mlid + 1, ml.light_offset.shape[0] - 1))
        u_cdf = u2[:, 0]

        def bs_body(_, carry):
            lo, hi = carry
            mid = (lo + hi) // 2
            val = jnp.take(ml.cdf, jnp.clip(mid, 0, ml.cdf.shape[0] - 1))
            go_right = val < u_cdf
            return jnp.where(go_right, mid + 1, lo), jnp.where(go_right, hi, mid)

        import jax as _jax

        lo, hi = _jax.lax.fori_loop(0, 32, bs_body, (start, jnp.maximum(end - 1, start)))
        pos = jnp.clip(lo, start, jnp.maximum(end - 1, start))
        prev_cdf = jnp.where(pos > start,
                             jnp.take(ml.cdf, jnp.clip(pos - 1, 0, ml.cdf.shape[0] - 1)), 0.0)
        cur_cdf = jnp.take(ml.cdf, jnp.clip(pos, 0, ml.cdf.shape[0] - 1))
        r1 = jnp.clip((u_cdf - prev_cdf) / jnp.maximum(cur_cdf - prev_cdf, 1e-9), 0.0, 1.0)
        tri = jnp.take(ml.tri_index, jnp.clip(pos, 0, ml.tri_index.shape[0] - 1))
        tv0, tv1, tv2, sn_mesh = take_rows(
            tri, (scene.triangles.v0, scene.triangles.v1,
                  scene.triangles.v2, scene.triangles.face_normal))
        sqrt_r1 = jnp.sqrt(r1)[:, None]
        r2 = u2[:, 1:2]
        sp_mesh = (1.0 - sqrt_r1) * tv0 + sqrt_r1 * (1.0 - r2) * tv1 + sqrt_r1 * r2 * tv2
        pdf_mesh = 1.0 / jnp.maximum(jnp.take(ml.surface_area, mlid), 1e-9)
        is_msh = ltype == T.LIGHT_MESH
        sp = jnp.where(is_msh[:, None], sp_mesh, sp)
        sn = jnp.where(is_msh[:, None], sn_mesh, sn)
        pdf_area = jnp.where(is_msh, pdf_mesh, pdf_area)

    is_rect = ltype == T.LIGHT_AREA_RECT
    is_sph = ltype == T.LIGHT_AREA_SPHERE
    is_dsk = ltype == T.LIGHT_AREA_DISK
    is_msh = ltype == T.LIGHT_MESH
    is_env = ltype == T.LIGHT_ENV
    is_dir = ltype == T.LIGHT_DIRECTIONAL
    is_pnt = ltype == T.LIGHT_POINT
    is_area = is_rect | is_sph | is_dsk | is_msh

    # Area lights: wi, solid-angle conversion (trace.h:298-309), facing
    # rejections (trace.h:316-323).
    to_sample = sp - hit_point
    dist_area = vm.length(to_sample)
    wi_area = vm.normalize(to_sample)
    conv = vm.length_sq(to_sample) / jnp.maximum(
        jnp.abs(vm.dot(sn, -wi_area)), 1e-12
    )
    pdf_area_sa = pdf_area * conv
    li_area = color * intensity[:, None]
    reject_area = (vm.dot(to_sample, sn) > 0.0) | (vm.dot(to_sample, shading_normal) < 0.0)

    wi, li, pdf, dist, reject = wi_area, li_area, pdf_area_sa, dist_area, reject_area

    if use(T.LIGHT_ENV):
        # Env facing rejection reduces to wi below the surface.
        reject_env = vm.dot(wi_env, shading_normal) < 0.0
        wi = jnp.where(is_env[:, None], wi_env, wi)
        li = jnp.where(is_env[:, None], li_env, li)
        pdf = jnp.where(is_env, pdf_env, pdf)
        dist = jnp.where(is_env, dist_env, dist)
        reject = jnp.where(is_env, reject_env, reject)

    if use(T.LIGHT_DIRECTIONAL, T.LIGHT_POINT):
        # ---- delta lights (DIRECTIONAL / POINTLIGHT, lights.h:18-34):
        # pdf 1, shadow ray toward the light ("infinity" for directional).
        wi_dir = vm.normalize(p0)  # p0 stores the direction toward the light
        li_dir = color * intensity[:, None]
        wi_pnt_raw = p0 - hit_point
        dist_pnt = vm.length(wi_pnt_raw)
        wi_pnt = vm.normalize(wi_pnt_raw)
        # point lights attenuate by 1/d^2 when dist_atten (getIncRadiance,
        # lights.cpp:41-55); radius slot stores the flag
        atten = jnp.where(radius > 0.0, 1.0 / jnp.maximum(dist_pnt * dist_pnt, 1e-6), 1.0)
        li_pnt = color * (intensity * atten)[:, None]
        wi = jnp.where(is_dir[:, None], wi_dir, wi)
        li = jnp.where(is_dir[:, None], li_dir, li)
        wi = jnp.where(is_pnt[:, None], wi_pnt, wi)
        li = jnp.where(is_pnt[:, None], li_pnt, li)
        one = jnp.ones_like(pdf)
        pdf = jnp.where(is_dir | is_pnt, one, pdf)
        dist = jnp.where(is_dir, jnp.broadcast_to(TMAX, dist.shape), dist)
        dist = jnp.where(is_pnt, dist_pnt, dist)
        reject_delta = vm.dot(wi, shading_normal) < 0.0
        reject = jnp.where(is_dir | is_pnt, reject_delta, reject)

    valid = (is_area | is_env | is_dir | is_pnt) & ~reject & (pdf > 1e-12)
    return LightSample(wi=wi, li=li, distance=dist, pdf=pdf, valid=valid)
