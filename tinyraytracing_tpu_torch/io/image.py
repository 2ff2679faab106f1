"""Tonemap + PNG output.

Identical tonemap to the reference so golden images compare directly:
``uint8(clamp(pow(linear, 1/2.2) * 255, 0, 255))`` with C-style truncating
cast (reference: RayTracingOnCPU/main.cpp:34-36; PNG written by the vendored
svpng — here Pillow). Output naming follows the reference's
``<basedir>/image<SPP>.png`` convention (main.cpp:26).
"""

from __future__ import annotations

import numpy as np


def tonemap_srgb(linear: np.ndarray) -> np.ndarray:
    """(H, W, 3) linear float -> (H, W, 3) uint8, reference-identical."""
    x = np.asarray(linear, dtype=np.float64)
    x = np.clip(np.power(np.maximum(x, 0.0), 1.0 / 2.2) * 255.0, 0.0, 255.0)
    return x.astype(np.uint8)  # truncation, like the reference's C cast


def write_png(path: str, linear: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(tonemap_srgb(linear), mode="RGB").save(path)


def read_png(path: str) -> np.ndarray:
    """Read a PNG as (H, W, 3) uint8 (for golden-image comparisons)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)
