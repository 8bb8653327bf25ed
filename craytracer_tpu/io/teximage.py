"""Texture/env-map image loading.

PPM textures go through the repo's own reader (io/image.py); other LDR
formats (PNG, JPEG, ...) through PIL, replacing stb_image
(texture.cpp:6-16). EXR env maps (imagefile.h:11-34 via OpenEXR) are read
by the pure-python reader in io/exr.py (NONE/ZIP/ZIPS scanline,
half/float) since OpenEXR bindings are not in the image. An unreadable
file raises: a texture never vanishes silently.

Reference quirk intentionally NOT copied: getTexColor divides float texels
by 255 (texture.cpp:78); HDR texels here stay in radiance units.
CRAY_TEX_FLOAT_DIV255=1 opts back into the reference behavior — used by
the textured golden-parity test so both renderers see the same EXR scale.
"""

from __future__ import annotations

import os

import numpy as np


def load_texture_image(path: str) -> np.ndarray:
    """Returns [H, W, 3] float32. LDR images are normalized to [0,1]; EXR
    keeps HDR values."""
    lower = path.lower()
    if lower.endswith(".exr"):
        from craytracer_tpu.io.exr import read_exr

        img = read_exr(path)
        if os.environ.get("CRAY_TEX_FLOAT_DIV255", "0") == "1":
            img = img / 255.0  # getTexColor float quirk (texture.cpp:78)
        return img
    if lower.endswith(".ppm"):
        from craytracer_tpu.io.image import read_ppm

        return read_ppm(path).astype(np.float32) / 255.0
    from PIL import Image  # PNG, JPEG and the other LDR formats

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 255.0
