"""Texture loading → padded device atlas.

The reference loads map_Kd images with cv::imread and samples them per-hit
with a BGR→RGB swizzle (reference: RayTracingOnCPU/material.cpp:3-11,
pathTracing.cpp:17-26). Here all textures of a scene are loaded once (PIL),
converted to RGB float32 in [0,1], and stacked into a single zero-padded
atlas array (NT, Hmax, Wmax, 3) so texture fetches inside jit are one gather
into one buffer; per-texture true (H, W) ride along for the reference's
``r = int(frac(row) * H)`` nearest-texel indexing.
"""

from __future__ import annotations

import numpy as np


def load_texture_atlas(paths: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Load images into (NT, Hmax, Wmax, 3) float32 atlas + (NT, 2) int32 HW.

    With no textures returns a (1, 1, 1, 3) dummy atlas so downstream shapes
    stay static.
    """
    if not paths:
        return (
            np.zeros((1, 1, 1, 3), dtype=np.float32),
            np.ones((1, 2), dtype=np.int32),
        )

    from PIL import Image

    imgs = []
    for p in paths:
        with Image.open(p) as im:
            imgs.append(np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0)

    hmax = max(im.shape[0] for im in imgs)
    wmax = max(im.shape[1] for im in imgs)
    atlas = np.zeros((len(imgs), hmax, wmax, 3), dtype=np.float32)
    hw = np.zeros((len(imgs), 2), dtype=np.int32)
    for i, im in enumerate(imgs):
        atlas[i, : im.shape[0], : im.shape[1]] = im
        hw[i] = (im.shape[0], im.shape[1])
    return atlas, hw
