"""Vectorized BSDF evaluation/sampling over hit queues.

The reference builds a per-hit list of BxDF pointers from a thread-shared
mutex-guarded pool (`computeScatteringFunc` materials.cpp:111-188 +
`mempool.cpp`) and dispatches through type switches (`reflection.cpp`).
Wavefront re-design: each material type maps to a *static* lobe
configuration, hit lanes gather their parameters from the flat material
table, and every lobe formula runs masked for all lanes — no allocation, no
branching, one fused program for a mixed-material wavefront.

Lobe configurations (computeScatteringFunc):
  MATTE       -> Oren-Nayar (sigma=0 degenerates exactly to Lambertian)
  MIRROR      -> SpecularReflection
  TRANSPARENT -> SpecularTransmission ("thin" mode, reflection.cpp:254-317)
  PLASTIC     -> FresnelBlendDiffuse + FresnelBlendSpecular (two lobes)
  GLASS       -> MicrofacetFresnel (reflection + transmission, Beckmann)
  METAL       -> MicrofacetReflection with conductor Fresnel
  EMISSIVE    -> no lobes

All directions here are in the local shading frame (z = shading normal).
Reference quirks preserved (they are image-visible):
  * FresnelBlendSpecular pdf = D(wh) / (2 dot(wo, wh))  (reflection.cpp:545-555)
  * glass reflection lobe uses 1 - Fr(wh, wi) in f (reflection.cpp:310-316)
  * transparent "thin" transmission: wi = -wo scaled by eta^2 (reflection.cpp:254-282)
Deviation: BSDF_f/BSDF_pdf in the reference pass *world* vectors into lobes
expecting local ones (reflection.cpp:719-748) — benign for Lambertian (the
only direction-independent case it exercises), undefined for the rest; we
evaluate in the local frame correctly.
"""

from __future__ import annotations

from craytracer_tpu.core import struct
import jax.numpy as jnp

from craytracer_tpu.constants import INV_PI, PI
from craytracer_tpu.core import math as vm
from craytracer_tpu.bsdf import microfacet as mf
from craytracer_tpu.bsdf.fresnel import fr_conductor, fr_dielectric, schlick_fresnel
from craytracer_tpu.bsdf.texture import tex_lookup_nearest
from craytracer_tpu.scene import types as T


@struct.dataclass
class MatParams:
    """Per-hit material parameters gathered from the table ([N, ...])."""

    mat_type: jnp.ndarray
    color: jnp.ndarray  # diffuse/cr/kd/emissive color (texture-resolved)
    ks: jnp.ndarray
    on_a: jnp.ndarray
    on_b: jnp.ndarray
    ior_in: jnp.ndarray
    ior_out: jnp.ndarray
    eta3: jnp.ndarray
    k3: jnp.ndarray
    alphax: jnp.ndarray
    alphay: jnp.ndarray
    distrib: jnp.ndarray
    intensity: jnp.ndarray
    color_raw: jnp.ndarray  # table color before texture resolution
    # (emissive radiance uses the raw material color, trace.h:421-427)
    normal_tex: jnp.ndarray  # int32 normal-map texture id or -1
    # Static: every MATTE row has sigma == 0 (scene.matte_lambertian), so
    # _oren_nayar_f's trig compiles away to color * on_a / pi.
    lambertian_only: bool = struct.field(pytree_node=False, default=False)


def gather_params(materials: T.Materials, textures: T.TexturePack, mat_id, uv,
                  lambertian_only: bool = False) -> MatParams:
    """The SoA "material -> BSDF factory": gather + texture eval
    (computeScatteringFunc's texture branch, materials.cpp:117-127).

    All 16 fields come from ONE fused row lookup (ops/gather.py) — the
    material table is packed loop-invariantly and fetched with a single
    one-hot matmul / gather instead of 16 latency-bound takes."""
    from craytracer_tpu.ops.gather import take_rows

    (mat_type, color, ks, on_a, on_b, ior_in, ior_out, eta3, k3, alphax,
     alphay, distrib, intensity, tex_id, normal_tex) = take_rows(
        mat_id, (materials.mat_type, materials.color, materials.ks,
                 materials.on_a, materials.on_b, materials.ior_in,
                 materials.ior_out, materials.eta, materials.k,
                 materials.alphax, materials.alphay, materials.distrib,
                 materials.intensity, materials.diffuse_tex,
                 materials.normal_tex))
    color_raw = color
    if textures.texels.shape[0] > 1:  # any real textures present
        tex_color = tex_lookup_nearest(textures, tex_id, uv)
        color = jnp.where((tex_id >= 0)[:, None], tex_color, color)
    # Floor alpha away from 0: non-microfacet rows carry alpha=0, and the
    # microfacet formulas (evaluated for EVERY lane, then masked) divide by
    # alpha^2 — jnp.where's backward pass turns those masked infs into NaN
    # gradients (NaN * 0). Real materials are never below ~1e-3 (the
    # BeckmannRoughnessToAlpha clamp, microfacet.h:26-32).
    alphax = jnp.maximum(alphax, 1e-4)
    alphay = jnp.maximum(alphay, 1e-4)
    return MatParams(
        mat_type=mat_type,
        color=color,
        ks=ks,
        on_a=on_a,
        on_b=on_b,
        ior_in=ior_in,
        ior_out=ior_out,
        eta3=eta3,
        k3=k3,
        alphax=alphax,
        alphay=alphay,
        distrib=distrib,
        intensity=intensity,
        color_raw=color_raw,
        normal_tex=normal_tex,
        lambertian_only=lambertian_only,
    )


# ---------------------------------------------------------------------------
# Individual lobe formulas (local frame).


def _oren_nayar_f(wi, wo, color, a, b, lambertian_only: bool = False):
    """OrenNayar_f (reflection.cpp:511-543); a=1,b=0 -> Lambertian.

    `lambertian_only` (static, from scene.matte_lambertian) skips the trig
    when every matte sigma is 0: f = color * a / pi exactly (a == 1), and
    the a-gradient is preserved; the b-gradient is zero on that path (b's
    coefficient needs the trig) — acceptable since b == 0 scenes have no
    b signal to recover."""
    if lambertian_only:
        return color * (a * INV_PI)[..., None]
    sin_ti = vm.sin_theta(wi)
    sin_to = vm.sin_theta(wo)
    d_cos = vm.cos_phi(wi) * vm.cos_phi(wo) + vm.sin_phi(wi) * vm.sin_phi(wo)
    max_cos = jnp.where((sin_ti > 1e-4) & (sin_to > 1e-4), jnp.maximum(0.0, d_cos), 0.0)
    aci = vm.abs_cos_theta(wi)
    aco = vm.abs_cos_theta(wo)
    wi_bigger = aci > aco
    sin_alpha = jnp.where(wi_bigger, sin_to, sin_ti)
    tan_beta = jnp.where(
        wi_bigger, sin_ti / jnp.maximum(aci, 1e-7), sin_to / jnp.maximum(aco, 1e-7)
    )
    return color * ((a + b * max_cos * sin_alpha * tan_beta) * INV_PI)[..., None]


def _cos_hemisphere_pdf(wi, wo):
    """cosHemispherePdf (reflection.cpp:6-17)."""
    return jnp.where(vm.same_hemisphere(wi, wo), vm.abs_cos_theta(wi) * INV_PI, 0.0)


def _fb_diffuse_f(wi, wo, kd, ks):
    """FresnelBlendDiffuse_f (reflection.cpp:484-496)."""
    p5 = lambda v: (v * v) * (v * v) * v
    scale = (
        (28.0 / (23.0 * PI))
        * (1.0 - p5(1.0 - 0.5 * vm.abs_cos_theta(wi)))
        * (1.0 - p5(1.0 - 0.5 * vm.abs_cos_theta(wo)))
    )
    return kd * (1.0 - ks) * scale[..., None]


def _fb_specular_f(wi, wo, ks, ax, ay, dist):
    """FresnelBlendSpecular_f (reflection.cpp:527-543)."""
    wh = wi + wo
    degenerate = vm.length_sq(wh) < 1e-16
    wh = vm.normalize(wh)
    cos_wh = vm.dot(wi, wh)
    fres = schlick_fresnel(cos_wh, ks)
    denom = 4.0 * jnp.abs(cos_wh) * jnp.maximum(
        jnp.maximum(vm.abs_cos_theta(wi), vm.abs_cos_theta(wo)), 1e-7
    )
    f = fres * (mf.distribution_d(wh, ax, ay, dist) / jnp.maximum(denom, 1e-12))[..., None]
    return jnp.where(degenerate[..., None], 0.0, f)


def _fb_specular_pdf(wi, wo, ax, ay, dist):
    """FresnelBlendSpecular_pdf — the reference's D/(2 dot(wo,wh)) quirk
    (reflection.cpp:545-555)."""
    same = vm.same_hemisphere(wi, wo)
    wh = vm.normalize(wi + wo)
    pdf = mf.distribution_d(wh, ax, ay, dist) / jnp.maximum(
        2.0 * vm.dot(wo, wh), 1e-7
    )
    return jnp.where(same, pdf, 0.0)


def _metal_f(wi, wo, color, eta3, k3, ax, ay, dist):
    """MicrofacetReflection_f, conductor branch (reflection.cpp:289-328)."""
    aci = vm.abs_cos_theta(wi)
    aco = vm.abs_cos_theta(wo)
    wh = wi + wo
    degenerate = (vm.length_sq(wh) < 1e-16) | (aci < 1e-7) | (aco < 1e-7)
    wh = vm.normalize(wh)
    fres = fr_conductor(vm.dot(wi, wh), eta3, jnp.ones_like(eta3), k3)
    scale = (
        mf.distribution_d(wh, ax, ay, dist)
        * mf.distribution_g(wo, wi, ax, ay, dist)
        / jnp.maximum(4.0 * aci * aco, 1e-12)
    )
    return jnp.where(degenerate[..., None], 0.0, color * fres * scale[..., None])


def _metal_pdf(wi, wo, ax, ay, dist):
    """MicrofacetReflection_pdf (reflection.cpp:346-353)."""
    same = vm.same_hemisphere(wi, wo)
    wh = vm.normalize(wi + wo)
    pdf = mf.distribution_pdf(wo, wh, ax, ay, dist) / jnp.maximum(
        4.0 * vm.dot(wo, wh), 1e-7
    )
    return jnp.where(same, pdf, 0.0)


def _glass_refl_f(wi, wo, color, ior_in, ior_out, ax, ay, dist):
    """Glass reflection lobe: MicrofacetReflection_f dielectric branch with
    the reference's 1 - Fr(wh, wi) quirk (reflection.cpp:303-316)."""
    aci = vm.abs_cos_theta(wi)
    aco = vm.abs_cos_theta(wo)
    wh = wi + wo
    degenerate = (vm.length_sq(wh) < 1e-16) | (aci < 1e-7) | (aco < 1e-7)
    wh = vm.normalize(wh)
    kr = 1.0 - fr_dielectric(vm.dot(wh, wi), ior_in, ior_out)
    scale = (
        mf.distribution_d(wh, ax, ay, dist)
        * mf.distribution_g(wo, wi, ax, ay, dist)
        / jnp.maximum(4.0 * aci * aco, 1e-12)
    )
    return jnp.where(degenerate[..., None], 0.0, color * (kr * scale)[..., None])


def _glass_trans_f(wi, wo, color, ior_in, ior_out, ax, ay, dist):
    """MicrofacetFresnel_f (reflection.cpp:356-388): transmission term."""
    not_trans = vm.same_hemisphere(wi, wo)
    cto = vm.cos_theta(wo)
    cti = vm.cos_theta(wi)
    eta = jnp.where(cto > 0.0, ior_in / ior_out, ior_out / ior_in)
    wh = vm.normalize(wo + wi * eta[..., None])
    wh = jnp.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    fr = fr_dielectric(vm.dot(wh, wo), ior_in, ior_out)
    sqrt_denom = vm.dot(wo, wh) + eta * vm.dot(wi, wh)
    denom = cti * cto * sqrt_denom * sqrt_denom
    num = (
        mf.distribution_d(wh, ax, ay, dist)
        * mf.distribution_g(wo, wi, ax, ay, dist)
        * jnp.abs(vm.dot(wi, wh))
        * jnp.abs(vm.dot(wo, wh))
    )
    f = color * ((1.0 - fr) * jnp.abs(num / vm._safe(denom)))[..., None]
    bad = not_trans | (jnp.abs(cti) < 1e-7) | (jnp.abs(cto) < 1e-7)
    return jnp.where(bad[..., None], 0.0, f)


def _glass_trans_pdf(wi, wo, ior_in, ior_out, ax, ay, dist):
    """MicrofacetFresnel_pdf (reflection.cpp:449-462)."""
    not_trans = vm.same_hemisphere(wi, wo)
    cto = vm.cos_theta(wo)
    eta = jnp.where(cto > 0.0, ior_in / ior_out, ior_out / ior_in)
    wh = vm.normalize(wo + wi * eta[..., None])
    sqrt_denom = vm.dot(wo, wh) + eta * vm.dot(wi, wh)
    dwh_dwi = jnp.abs(eta * eta * vm.dot(wi, wh)) / jnp.maximum(sqrt_denom * sqrt_denom, 1e-12)
    pdf = mf.distribution_pdf(wo, wh, ax, ay, dist) * dwh_dwi
    return jnp.where(not_trans, 0.0, pdf)


# ---------------------------------------------------------------------------
# Aggregate BSDF ops, masked across material types.


def _use(present, *codes) -> bool:
    """Static lobe gate: `present` is the scene's mat_types_present
    (None/empty = unknown -> evaluate everything). jit specializes on it,
    so absent material types compile to NOTHING — the batched answer to the
    reference's per-hit BxDF-list construction (materials.cpp:111-188)."""
    return not present or any(c in present for c in codes)


def bsdf_f_direct(wi, wo, mp: MatParams, present=None):
    """BSDF_f with SPECULAR|GLOSSY excluded — the NEE evaluation
    (estimateDirect, trace.h:328; exclusion set at trace.h:410). Only
    diffuse lobes survive: MATTE's Oren-Nayar and PLASTIC's FB-diffuse."""
    f = jnp.zeros_like(wi)
    if _use(present, T.MAT_MATTE):
        f_matte = _oren_nayar_f(wi, wo, mp.color, mp.on_a, mp.on_b,
                                 mp.lambertian_only)
        f = jnp.where((mp.mat_type == T.MAT_MATTE)[..., None], f_matte, f)
    if _use(present, T.MAT_PLASTIC):
        f_plastic = _fb_diffuse_f(wi, wo, mp.color, mp.ks)
        f = jnp.where((mp.mat_type == T.MAT_PLASTIC)[..., None], f_plastic, f)
    return f


def bsdf_f_nodelta(wi, wo, mp: MatParams, present=None):
    """All finite (non-delta) lobes, glossy included — the NEE evaluation
    for the MIS estimator, which needs light sampling to cover everything
    BSDF sampling covers. Glass uses the proper Fresnel-weighted reflection
    term (F, not the reference's 1-F quirk)."""
    f = jnp.zeros_like(wi)
    if _use(present, T.MAT_MATTE):
        f = jnp.where((mp.mat_type == T.MAT_MATTE)[..., None],
                      _oren_nayar_f(wi, wo, mp.color, mp.on_a, mp.on_b,
                                    mp.lambertian_only), f)
    if _use(present, T.MAT_PLASTIC):
        f_plastic = _fb_diffuse_f(wi, wo, mp.color, mp.ks) + _fb_specular_f(
            wi, wo, mp.ks, mp.alphax, mp.alphay, mp.distrib)
        f = jnp.where((mp.mat_type == T.MAT_PLASTIC)[..., None], f_plastic, f)
    if _use(present, T.MAT_METAL):
        f_metal = _metal_f(wi, wo, jnp.ones_like(mp.color), mp.eta3, mp.k3,
                           mp.alphax, mp.alphay, mp.distrib)
        f = jnp.where((mp.mat_type == T.MAT_METAL)[..., None], f_metal, f)
    if _use(present, T.MAT_GLASS):
        white = jnp.ones_like(mp.color)
        same = vm.same_hemisphere(wi, wo)
        wh_r = vm.normalize(wi + wo)
        fr_r = fr_dielectric(vm.dot(wh_r, wo), mp.ior_in, mp.ior_out)
        f_gr = _glass_refl_f(wi, wo, white, mp.ior_in, mp.ior_out,
                             mp.alphax, mp.alphay, mp.distrib)
        # replace the (1-Fr) quirk term with Fr for the balanced mode
        quirk = 1.0 - fr_dielectric(vm.dot(wh_r, wi), mp.ior_in, mp.ior_out)
        f_gr = f_gr * (fr_r / jnp.maximum(quirk, 1e-6))[..., None]
        f_gt = _glass_trans_f(wi, wo, white, mp.ior_in, mp.ior_out,
                              mp.alphax, mp.alphay, mp.distrib)
        f_glass = jnp.where(same[..., None], f_gr, f_gt)
        f = jnp.where((mp.mat_type == T.MAT_GLASS)[..., None], f_glass, f)
    return f


def _glass_pdf_mixture(wi, wo, mp: MatParams):
    """Sampling density of the glass lobe under the fresnel branch choice:
    p(wi) = kr * p_refl for reflection-side wi, (1-kr) * p_trans otherwise."""
    same = vm.same_hemisphere(wi, wo)
    wh_r = vm.normalize(wi + wo)
    kr_r = fr_dielectric(vm.dot(wh_r, wo), mp.ior_in, mp.ior_out)
    pdf_r = mf.distribution_pdf(wo, wh_r, mp.alphax, mp.alphay, mp.distrib) / jnp.maximum(
        4.0 * vm.dot(wo, wh_r), 1e-7)
    cto = vm.cos_theta(wo)
    eta = jnp.where(cto > 0.0, mp.ior_in / mp.ior_out, mp.ior_out / mp.ior_in)
    wh_t = vm.normalize(wo + wi * eta[..., None])
    kr_t = fr_dielectric(vm.dot(wh_t, wo), mp.ior_in, mp.ior_out)
    pdf_t = _glass_trans_pdf(wi, wo, mp.ior_in, mp.ior_out,
                             mp.alphax, mp.alphay, mp.distrib)
    return jnp.where(same, kr_r * pdf_r, (1.0 - kr_t) * pdf_t)


def bsdf_pdf_balanced(wi, wo, mp: MatParams, present=None):
    """Correct one-sample mixture density of bsdf_sample(balanced=True):
    plastic averages its two lobes (the reference SUMS them,
    reflection.cpp:789-797 — a quirk kept only in reference mode)."""
    pdf = jnp.zeros(wi.shape[:-1], wi.dtype)
    if _use(present, T.MAT_MATTE):
        pdf = jnp.where(mp.mat_type == T.MAT_MATTE,
                        _cos_hemisphere_pdf(wi, wo), pdf)
    if _use(present, T.MAT_PLASTIC):
        pdf_plastic = 0.5 * (_cos_hemisphere_pdf(wi, wo) + _fb_specular_pdf(
            wi, wo, mp.alphax, mp.alphay, mp.distrib))
        pdf = jnp.where(mp.mat_type == T.MAT_PLASTIC, pdf_plastic, pdf)
    if _use(present, T.MAT_METAL):
        pdf = jnp.where(mp.mat_type == T.MAT_METAL,
                        _metal_pdf(wi, wo, mp.alphax, mp.alphay, mp.distrib), pdf)
    if _use(present, T.MAT_GLASS):
        pdf = jnp.where(mp.mat_type == T.MAT_GLASS,
                        _glass_pdf_mixture(wi, wo, mp), pdf)
    return pdf


def bsdf_pdf(wi, wo, mp: MatParams, present=None):
    """BSDF_pdf: sum of lobe pdfs (reflection.cpp:737-748)."""
    pdf = jnp.zeros(wi.shape[:-1], wi.dtype)
    if _use(present, T.MAT_MATTE):
        pdf = jnp.where(mp.mat_type == T.MAT_MATTE,
                        _cos_hemisphere_pdf(wi, wo), pdf)
    if _use(present, T.MAT_PLASTIC):
        pdf_plastic = _cos_hemisphere_pdf(wi, wo) + _fb_specular_pdf(
            wi, wo, mp.alphax, mp.alphay, mp.distrib
        )
        pdf = jnp.where(mp.mat_type == T.MAT_PLASTIC, pdf_plastic, pdf)
    if _use(present, T.MAT_METAL):
        pdf = jnp.where(mp.mat_type == T.MAT_METAL,
                        _metal_pdf(wi, wo, mp.alphax, mp.alphay, mp.distrib), pdf)
    if _use(present, T.MAT_GLASS):
        pdf_glass = _glass_trans_pdf(wi, wo, mp.ior_in, mp.ior_out,
                                     mp.alphax, mp.alphay, mp.distrib)
        pdf = jnp.where(mp.mat_type == T.MAT_GLASS, pdf_glass, pdf)
    return pdf


def bsdf_sample(u, wo, mp: MatParams, balanced: bool = False, present=None):
    """BSDF_sample_f (reflection.cpp:750-811) for the whole hit queue.

    `u` is [N, 3]: (lobe-select/sample.x, sample.y, fresnel-branch rand —
    the reference's extra rand() in SpecularTransmission/MicrofacetFresnel).

    `balanced=True` switches the reported densities (and glass reflection
    Fresnel) to the correct one-sample mixture pdfs used by the MIS
    estimator; False reproduces the reference's reported values.

    `present` statically gates the lobe families (see `_use`): a matte-only
    scene compiles to just the cosine-hemisphere block.

    Returns (f[N,3], wi[N,3], pdf[N], is_specular[N], is_glossy[N]).
    """
    from craytracer_tpu.sampling.mappings import map_to_hemisphere_cosine

    mtype = mp.mat_type
    u2 = u[:, :2]
    r_extra = u[:, 2]

    def sel(mtype_code, val_f, val_wi, val_pdf, f, wi, pdf):
        m = mtype == mtype_code
        return (
            jnp.where(m[:, None], val_f, f),
            jnp.where(m[:, None], val_wi, wi),
            jnp.where(m, val_pdf, pdf),
        )

    f = jnp.zeros_like(wo)
    wi = jnp.zeros_like(wo).at[:, 2].set(1.0)
    pdf = jnp.zeros(wo.shape[:-1], wo.dtype)
    false_n = jnp.zeros(wo.shape[:-1], bool)
    is_specular = false_n
    is_glossy = false_n

    if _use(present, T.MAT_MATTE):
        # ---- MATTE: cosine-hemisphere sample (OrenNayar_sample_f,
        # reflection.cpp:550-562); wo's hemisphere is forced positive for
        # the sample, f evaluated with the original wo.
        wi_matte = map_to_hemisphere_cosine(u2)
        pdf_matte = vm.abs_cos_theta(wi_matte) * INV_PI
        f_matte = _oren_nayar_f(wi_matte, wo, mp.color, mp.on_a, mp.on_b,
                                 mp.lambertian_only)
        f, wi, pdf = sel(T.MAT_MATTE, f_matte, wi_matte, pdf_matte, f, wi, pdf)

    if _use(present, T.MAT_MIRROR):
        # ---- MIRROR (SpecularReflection_sample_f, reflection.cpp:240-247)
        wi_mirror = jnp.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], axis=-1)
        f_mirror = mp.color / jnp.maximum(vm.abs_cos_theta(wi_mirror), 1e-7)[..., None]
        pdf_mirror = jnp.ones_like(pdf)
        f, wi, pdf = sel(T.MAT_MIRROR, f_mirror, wi_mirror, pdf_mirror, f, wi, pdf)
        is_specular = is_specular | (mtype == T.MAT_MIRROR)

    if _use(present, T.MAT_TRANSPARENT):
        # ---- TRANSPARENT thin (SpecularTransmission_sample_f "thin"
        # branch, reflection.cpp:250-282)
        kr_thin = fr_dielectric(jnp.abs(wo[:, 2]), mp.ior_in, mp.ior_out)
        take_refl = r_extra <= kr_thin
        wi_trans = jnp.where(
            take_refl[:, None],
            jnp.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], axis=-1),
            -wo,
        )
        eta_thin = mp.ior_out / mp.ior_in
        mag_trans = jnp.where(
            take_refl,
            kr_thin,
            (1.0 - kr_thin) * eta_thin * eta_thin,
        ) / jnp.maximum(vm.abs_cos_theta(wi_trans), 1e-7)
        f_trans = jnp.broadcast_to(mag_trans[:, None], wo.shape)
        pdf_trans = jnp.where(take_refl, kr_thin, 1.0 - kr_thin)
        f, wi, pdf = sel(T.MAT_TRANSPARENT, f_trans, wi_trans, pdf_trans, f, wi, pdf)
        is_specular = is_specular | (mtype == T.MAT_TRANSPARENT)

    if _use(present, T.MAT_PLASTIC):
        # ---- PLASTIC: 2 lobes, uniform lobe choice with sample remap
        # (BSDF_sample_f, reflection.cpp:760-766), then both lobes' f and
        # pdf are summed (reflection.cpp:789-811).
        pick_spec = u2[:, 0] >= 0.5
        u_remap = jnp.stack([jnp.where(pick_spec, 2.0 * (u2[:, 0] - 0.5), 2.0 * u2[:, 0]),
                             u2[:, 1]], axis=-1)
        u_remap = jnp.clip(u_remap, 0.0, 1.0 - 1e-7)
        # diffuse lobe sample (FresnelBlendDiffuse_sample_f, reflection.cpp:498-506)
        wi_pd = map_to_hemisphere_cosine(u_remap)
        wi_pd = jnp.where((wo[:, 2] < 0.0)[:, None], wi_pd * jnp.array([1.0, 1.0, -1.0]), wi_pd)
        # specular lobe sample (FresnelBlendSpecular_sample_f, reflection.cpp:545-556)
        wh_p = mf.sample_wh(wo, u_remap, mp.alphax, mp.alphay, mp.distrib)
        wi_ps = vm.reflect(wo, wh_p)
        ps_ok = vm.same_hemisphere(wo, wi_ps)
        wi_plastic = jnp.where(pick_spec[:, None], wi_ps, wi_pd)
        # chosen-lobe pdf must be nonzero or the sample dies (reflection.cpp:779-784)
        pdf_chosen = jnp.where(
            pick_spec,
            jnp.where(ps_ok, _fb_specular_pdf(wi_plastic, wo, mp.alphax, mp.alphay, mp.distrib), 0.0),
            _cos_hemisphere_pdf(wi_plastic, wo),
        )
        pdf_other = jnp.where(
            pick_spec,
            _cos_hemisphere_pdf(wi_plastic, wo),
            _fb_specular_pdf(wi_plastic, wo, mp.alphax, mp.alphay, mp.distrib),
        )
        alive_p = pdf_chosen > 0.0
        f_plastic = _fb_diffuse_f(wi_plastic, wo, mp.color, mp.ks) + _fb_specular_f(
            wi_plastic, wo, mp.ks, mp.alphax, mp.alphay, mp.distrib
        )
        # reference SUMS the lobe pdfs (reflection.cpp:789-797); the
        # balanced mode uses the correct mixture average
        pdf_plastic = jnp.where(alive_p, pdf_chosen + pdf_other, 0.0)
        if balanced:
            pdf_plastic = 0.5 * pdf_plastic
        f_plastic = jnp.where(alive_p[:, None], f_plastic, 0.0)
        f, wi, pdf = sel(T.MAT_PLASTIC, f_plastic, wi_plastic, pdf_plastic, f, wi, pdf)
        is_glossy = is_glossy | ((mtype == T.MAT_PLASTIC) & pick_spec)

    if _use(present, T.MAT_METAL):
        # ---- METAL (MicrofacetReflection_sample_f, reflection.cpp:329-344)
        wh_m = mf.sample_wh(wo, u2, mp.alphax, mp.alphay, mp.distrib)
        wi_metal = vm.reflect(wo, wh_m)
        m_ok = vm.same_hemisphere(wo, wi_metal)
        f_metal = _metal_f(wi_metal, wo, jnp.ones_like(mp.color), mp.eta3, mp.k3,
                           mp.alphax, mp.alphay, mp.distrib)
        pdf_metal = mf.distribution_pdf(wo, wh_m, mp.alphax, mp.alphay, mp.distrib) / jnp.maximum(
            4.0 * vm.dot(wo, wh_m), 1e-7
        )
        f_metal = jnp.where(m_ok[:, None], f_metal, 0.0)
        pdf_metal = jnp.where(m_ok, pdf_metal, 0.0)
        f, wi, pdf = sel(T.MAT_METAL, f_metal, wi_metal, pdf_metal, f, wi, pdf)
        is_glossy = is_glossy | (mtype == T.MAT_METAL)

    if _use(present, T.MAT_GLASS):
        # ---- GLASS (MicrofacetFresnel_sample_f, reflection.cpp:390-446)
        white = jnp.ones_like(mp.color)
        wh_g = mf.sample_wh(wo, u2, mp.alphax, mp.alphay, mp.distrib)
        kr_g = fr_dielectric(vm.dot(wh_g, wo), mp.ior_in, mp.ior_out)
        g_refl = r_extra <= kr_g
        # reflection branch
        wi_gr = vm.reflect(wo, wh_g)
        gr_ok = vm.same_hemisphere(wo, wi_gr)
        f_gr = _glass_refl_f(wi_gr, wo, white, mp.ior_in, mp.ior_out,
                             mp.alphax, mp.alphay, mp.distrib)
        if balanced:
            # proper Fresnel weight F (not the reference's 1 - Fr(wh, wi) quirk)
            wh_r = vm.normalize(wi_gr + wo)
            quirk = 1.0 - fr_dielectric(vm.dot(wh_r, wi_gr), mp.ior_in, mp.ior_out)
            fr_r = fr_dielectric(vm.dot(wh_r, wo), mp.ior_in, mp.ior_out)
            f_gr = f_gr * (fr_r / jnp.maximum(quirk, 1e-6))[:, None]
        pdf_gr = mf.distribution_pdf(wo, wh_g, mp.alphax, mp.alphay, mp.distrib) / jnp.maximum(
            4.0 * vm.dot(wo, wh_g), 1e-7
        )
        if balanced:
            pdf_gr = kr_g * pdf_gr
        f_gr = jnp.where(gr_ok[:, None], f_gr, 0.0)
        pdf_gr = jnp.where(gr_ok, pdf_gr, 0.0)
        # transmission branch
        eta_g = jnp.where(vm.cos_theta(wo) > 0.0, mp.ior_out / mp.ior_in, mp.ior_in / mp.ior_out)
        wh_face = jnp.where(vm.dot(wh_g, wo)[..., None] < 0.0, -wh_g, wh_g)
        gt_ok, wi_gt = vm.refract(wo, wh_face, eta_g)
        f_gt = _glass_trans_f(wi_gt, wo, white, mp.ior_in, mp.ior_out,
                              mp.alphax, mp.alphay, mp.distrib)
        pdf_gt = _glass_trans_pdf(wi_gt, wo, mp.ior_in, mp.ior_out,
                                  mp.alphax, mp.alphay, mp.distrib)
        if balanced:
            pdf_gt = (1.0 - kr_g) * pdf_gt
        f_gt = jnp.where(gt_ok[:, None], f_gt, 0.0)
        pdf_gt = jnp.where(gt_ok, pdf_gt, 0.0)
        wi_glass = jnp.where(g_refl[:, None], wi_gr, wi_gt)
        f_glass = jnp.where(g_refl[:, None], f_gr, f_gt)
        pdf_glass = jnp.where(g_refl, pdf_gr, pdf_gt)
        f, wi, pdf = sel(T.MAT_GLASS, f_glass, wi_glass, pdf_glass, f, wi, pdf)
        is_glossy = is_glossy | (mtype == T.MAT_GLASS)

    return f, wi, pdf, is_specular, is_glossy
