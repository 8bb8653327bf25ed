"""Golden-image parity against the reference binary's own renders.

tests/goldens/golden_<name>.is are raw accumulators written by the
reference renderer on scenes/parity_<name>.txt (see
tests/test_reference_parity.py for how each was captured). `compare`
renders the same scene text through the full pipeline (parser -> build ->
Renderer, estimator='reference') and compares tone-mapped block means:
the test and chip_smoke.py share it, so the card is held to the same
thresholds as the CPU.
"""

from __future__ import annotations

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SCENES = ("cornell", "mix", "prims", "mesh", "mesh_mid", "textured")

# Thresholds, ~4x the observed same-implementation run-to-run spread:
# overall tone-mapped mean within 2% (floor 0.05), every 8x8 block within
# 0.05 and 90% of blocks within 0.02 (tone-mapped units out of ~1.0).
MEAN_REL = 0.02
BLOCK_MAX = 0.05
BLOCK_TIGHT = 0.02
BLOCK_TIGHT_FRAC = 0.9


def tonemapped(img: np.ndarray) -> np.ndarray:
    """Reference tone map (shading.h:33-63): exposure -2, gamma 2.2.
    Bounded [0,1), so Monte-Carlo firefly tails are compressed and block
    statistics are stable — and it is the metric a user actually sees.

    Negatives are clipped first: the reference binary emits rare garbage
    samples (the committed cornell golden contains one pixel at -2.4e18 —
    finite, so it slips the reference's own isnan/isinf guard at
    main.cpp:127-136)."""
    lum = np.clip(img, 0.0, None)
    return (1.0 - np.exp(-2.0 * lum)) ** (1.0 / 2.2)


def block_means(img: np.ndarray, blocks: int = 8):
    h, w, _ = img.shape
    tm = tonemapped(img).mean(-1)
    return tm.reshape(blocks, h // blocks, blocks, w // blocks).mean(
        axis=(1, 3))


def render_ours(scene_path: str, size: int = 128, spp: int = 64,
                accel: str = "auto"):
    from craytracer_tpu.camera import Film
    from craytracer_tpu.integrator import Renderer, RenderConfig
    from craytracer_tpu.io.scenefile import load_scene_file

    scene, cam, film = load_scene_file(scene_path, accel=accel)
    film = Film(fov=film.fov, width=size, height=size)
    r = Renderer(scene, cam, film,
                 RenderConfig(num_samples=spp, max_depth=5,
                              estimator="reference"))
    r.render()
    return np.asarray(r.raw_mean()).reshape(size, size, 3)


def compare(name: str) -> dict:
    """Render parity scene `name` at the golden settings and return the
    agreement figures: ours/ref tone-mapped means, the largest block
    deviation, the fraction of blocks within BLOCK_TIGHT, and `ok`."""
    from craytracer_tpu.io.imagestate import read_reference_is

    accum, spp, w, h = read_reference_is(
        os.path.join(REPO, "tests", "goldens", f"golden_{name}.is"))
    ref = (accum / spp).reshape(h, w, 3)
    # mesh_mid was captured with the reference's GRID accel and renders
    # here through bvh4 — accelerated-path evidence on both sides (the
    # other goldens are accel NONE).
    accel = "bvh4" if name == "mesh_mid" else "auto"
    spp_ours = 64
    old_div = os.environ.get("CRAY_TEX_FLOAT_DIV255")
    if name == "textured":
        # match the reference's float-texel /255 (texture.cpp:78) so both
        # renderers see the same EXR scale; 160 spp tames env fireflies
        os.environ["CRAY_TEX_FLOAT_DIV255"] = "1"
        spp_ours = 160
    try:
        ours = render_ours(os.path.join(REPO, "scenes",
                                        f"parity_{name}.txt"),
                           accel=accel, spp=spp_ours)
    finally:
        if name == "textured":
            if old_div is None:
                os.environ.pop("CRAY_TEX_FLOAT_DIV255", None)
            else:
                os.environ["CRAY_TEX_FLOAT_DIV255"] = old_div
    dev = np.abs(block_means(ours) - block_means(ref))
    full_r = float(tonemapped(ref).mean())
    full_o = float(tonemapped(ours).mean())
    tight = float((dev < BLOCK_TIGHT).mean())
    ok = (abs(full_o - full_r) < MEAN_REL * max(full_r, 0.05)
          and float(dev.max()) < BLOCK_MAX and tight > BLOCK_TIGHT_FRAC)
    return {"name": name, "mean_ours": full_o, "mean_ref": full_r,
            "block_dev_max": float(dev.max()), "blocks_tight": tight,
            "ok": bool(ok)}
