"""Scene kind ``quad_grid``: the displaced checkerboard of small quads over
the Cornell box's floor that the repository's BASELINE configs 3 and 5
render at 100K and 1M triangles: ``triangles`` of floor quads (heights
20 + 120 u^2, u from ``grid_seed``) inside the box without its blocks,
then the light quad; the box's materials, light and camera."""

import numpy as np

from core import scenes


def build(width: int, height: int, triangles: int, grid_seed: int = 0) -> dict:
    box = scenes.kind("cornell_box")
    names: list[str] = []
    v_box, m_box = scenes.quads(box.BOX, names)
    rng = np.random.default_rng(grid_seed)
    n_quads = max(triangles // 2, 1)
    g = int(np.ceil(np.sqrt(n_quads)))
    xs = np.linspace(30.0, 520.0, g + 1)
    zs = np.linspace(30.0, 520.0, g + 1)
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    ii, jj = ii.ravel()[:n_quads], jj.ravel()[:n_quads]
    y = 20.0 + 120.0 * rng.random(n_quads) ** 2
    x0, x1, z0, z1 = xs[ii], xs[ii + 1], zs[jj], zs[jj + 1]
    c0 = np.stack([x0, y, z0], 1)
    c1 = np.stack([x1, y, z0], 1)
    c2 = np.stack([x1, y, z1], 1)
    c3 = np.stack([x0, y, z1], 1)
    v_grid = np.empty((2 * n_quads, 3, 3))
    v_grid[0::2, 0], v_grid[0::2, 1], v_grid[0::2, 2] = c0, c1, c2
    v_grid[1::2, 0], v_grid[1::2, 1], v_grid[1::2, 2] = c0, c2, c3
    white = names.index("DiffuseWhite")
    v_light, m_light = scenes.quads([box.LIGHT], names)
    v = np.concatenate([v_box, v_grid, v_light])
    mtl = np.concatenate([m_box, np.full(len(v_grid), white, np.int32), m_light])
    return scenes.finish(v, mtl, names, box.MATERIALS, box.LIGHTS, box.camera(width, height))
