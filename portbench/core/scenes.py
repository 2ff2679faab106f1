"""The benchmark's scenes as raw host arrays, made here and handed alike
to the program (``core.port.build_scene``) and to the plain reference
(``core.reference.RefScene``).

A configuration file's ``scene`` entry names a scene ``kind`` and its
parameters; the kind is the module ``scenes/<kind>.py``, found by name,
whose ``build(width, height, **parameters)`` returns the raw scene. A
later configuration with a scene of its own adds such a file.

A raw scene is a dict: ``v`` (T, 3, 3) float64 corners, ``vn`` (T, 3, 3)
vertex normals, ``normal`` (T, 3) unit geometric normals, ``mtl`` (T,)
int32 indices into ``mtl_names``, ``materials`` {name: kd, ks, tr, ns,
ni}, ``lights`` [(material name, radiance)], ``camera`` {eye, lookat, up,
fovy, width, height}.
"""

from __future__ import annotations

import numpy as np

from core import harness


def kind(name: str):
    """The scene kind module ``scenes/<name>.py``."""
    return harness.load_module(harness.BENCH_DIR / "scenes" / f"{name}.py",
                               f"portbench_scene_{name}")


def unit_normals(v: np.ndarray) -> np.ndarray:
    gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    return gn / np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-30)


def quads(quads, names: list[str]):
    """Two triangles (c0 c1 c2, c0 c2 c3) per (corners, material) quad;
    material names are interned into ``names`` in order of appearance."""
    tri_v, tri_m = [], []
    for corners, mtl in quads:
        if mtl not in names:
            names.append(mtl)
        c = [np.asarray(p, np.float64) for p in corners]
        tri_v += [[c[0], c[1], c[2]], [c[0], c[2], c[3]]]
        tri_m += [names.index(mtl)] * 2
    return np.asarray(tri_v), np.asarray(tri_m, np.int32)


def finish(v, mtl, names, materials, lights, camera) -> dict:
    """The raw scene of triangles ``v`` with flat vertex normals."""
    gn = unit_normals(v)
    return dict(v=v, vn=np.repeat(gn[:, None, :], 3, axis=1), normal=gn,
                mtl=mtl, mtl_names=list(names), materials=dict(materials),
                lights=list(lights), camera=dict(camera))


def build(config: dict, width: int | None = None, height: int | None = None) -> dict:
    """The raw scene of a configuration file's ``scene`` entry, at the
    configuration's image size unless ``width``/``height`` are given."""
    spec = dict(config["scene"])
    name = spec.pop("kind")
    w = int(width if width is not None else config["width"])
    h = int(height if height is not None else config["height"])
    return kind(name).build(width=w, height=h, **spec)
