"""Scene kind ``height_grid``: a connected heightfield over the Cornell box's
floor, the mesh whose shared vertices the gradient steps of ``hfield100k``
move. ``cells`` x ``cells`` grid cells of two triangles each over x, z in
[30, 520] (where ``quad_grid`` places its quads: the box without its
blocks), on (cells + 1)^2 shared vertices at heights 20 + 120 s(x, z): s is
a normalised sum of ``bumps`` Gaussian bumps drawn from ``grid_seed``, a
smooth field in [0, 1]. Every triangle faces up and is flat-shaded. Then
the light quad; the box's materials, light and camera.

Besides the raw scene's arrays, the scene carries ``vertex_positions``
(V, 3), ``vertex_index`` (T_mesh, 3) into them and ``mesh_range`` (lo,
hi): the triangles [lo, hi) are the mesh, corner k of triangle lo + i
being ``vertex_positions[vertex_index[i, k]]``.
"""

import numpy as np

from core import scenes

LO, HI = 30.0, 520.0


def field(x, z, rng: np.random.Generator, bumps: int):
    """A smooth field of the floor's points, normalised to [0, 1] over the
    points given: a sum of ``bumps`` Gaussian bumps of random centre,
    width and signed weight."""
    cx, cz = rng.uniform(LO, HI, bumps), rng.uniform(LO, HI, bumps)
    width = rng.uniform(40.0, 120.0, bumps)
    weight = rng.uniform(-1.0, 1.0, bumps)
    d2 = (x[..., None] - cx) ** 2 + (z[..., None] - cz) ** 2
    f = (weight * np.exp(-0.5 * d2 / width ** 2)).sum(-1)
    return (f - f.min()) / max(f.max() - f.min(), 1e-30)


def grid(cells: int, heights):
    """(vertex positions (V, 3), vertex ids (2 cells^2, 3)) of the grid
    with vertex (i, j) at x[i], z[j] and height ``heights[i, j]``; cell
    (i, j) is the triangles (00, 01, 11) and (00, 11, 10), both facing
    up (+y)."""
    g = np.linspace(LO, HI, cells + 1)
    xx, zz = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([xx, heights, zz], -1).reshape(-1, 3)
    vid = np.arange((cells + 1) ** 2).reshape(cells + 1, cells + 1)
    a, b = vid[:-1, :-1].ravel(), vid[:-1, 1:].ravel()      # (i, j), (i, j + 1)
    c, d = vid[1:, 1:].ravel(), vid[1:, :-1].ravel()        # (i + 1, j + 1), (i + 1, j)
    index = np.stack([np.stack([a, b, c], 1), np.stack([a, c, d], 1)], 1).reshape(-1, 3)
    return pos, index


def build(width: int, height: int, cells: int, grid_seed: int = 0, bumps: int = 16) -> dict:
    box = scenes.kind("cornell_box")
    names: list[str] = []
    v_box, m_box = scenes.quads(box.BOX, names)
    g = np.linspace(LO, HI, cells + 1)
    xx, zz = np.meshgrid(g, g, indexing="ij")
    heights = 20.0 + 120.0 * field(xx, zz, np.random.default_rng(grid_seed), bumps)
    pos, index = grid(cells, heights)
    white = names.index("DiffuseWhite")
    v_light, m_light = scenes.quads([box.LIGHT], names)
    v = np.concatenate([v_box, pos[index], v_light])
    mtl = np.concatenate([m_box, np.full(len(index), white, np.int32), m_light])
    raw = scenes.finish(v, mtl, names, box.MATERIALS, box.LIGHTS, box.camera(width, height))
    raw.update(vertex_positions=pos, vertex_index=index,
               mesh_range=(len(v_box), len(v_box) + len(index)))
    return raw
