"""Render checkpoint and resume, ported from
``tinyraytracing_tpu/utils/checkpoint.py``.

- ``save/load/clear_queue_state``: snapshots of the queue renderer's lane
  state between chunks (``integrator/fused_queue.py::
  render_fused_queue_chunked``), written atomically. A resumed render
  continues the same loop from the same state, so it is bitwise the
  uninterrupted one on the CPU.
- ``render_checkpointed``: the scan renderer in chunks of passes,
  persisting the accumulated image after every chunk; pass s always draws
  with ``fold_in(key, s)``, so a resumed render is bitwise the
  uninterrupted one.

The port's snapshots are its own: its lane state keeps int64 planes where
the JAX package keeps int32 and uint32 ones, and the meta names the port's
layout, so a snapshot of either package is rejected by the other.
"""

from __future__ import annotations

import os

import numpy as np

from tinyraytracing_tpu_torch.config import RenderConfig

# bump whenever the queue state's layout changes
# (fused_queue.STATE_LAYOUT): older snapshots are then rejected by the meta
QUEUE_STATE_VERSION = 1
# what render_checkpointed's file holds, bound into it
SCAN_STATE_FORMAT = "tinyraytracing_tpu_torch.render_checkpointed/1"


def scene_checksum(scene) -> float:
    """Scene identity bound into queue snapshots: the float64 sum of the
    vertices, shading normals, materials and emission, so a snapshot
    cannot resume against a scene that differs only in, say, normals or
    radiance."""
    return float(sum(float(getattr(scene, f).double().sum())
                     for f in ("v0", "v1", "v2", "n0", "kd", "ks",
                               "radiance")))


def _atomic_savez(path: str, **arrays) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def save_queue_state(path: str, leaves, meta: dict) -> None:
    """Snapshot the queue renderer's lane state (a list of numpy arrays,
    ``fused_queue._flatten``) with its meta."""
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["n_leaves"] = np.int64(len(leaves))
    for k, v in meta.items():
        arrays[f"meta_{k}"] = np.asarray(v)
    _atomic_savez(path, **arrays)


def load_queue_state(path: str, meta: dict):
    """The state leaves of the snapshot at ``path``, in saved order, or
    None if there is none or its meta differs from ``meta`` in any key."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        for k, v in meta.items():
            mk = f"meta_{k}"
            if mk not in z or not np.array_equal(z[mk], np.asarray(v)):
                return None
        return [z[f"leaf_{i}"] for i in range(int(z["n_leaves"]))]


def clear_queue_state(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


def render_checkpointed(
    scene,
    cam,
    config: RenderConfig,
    spp: int,
    ckpt_path: str,
    seed: int = 0,
    chunk: int = 16,
    progress=None,
) -> np.ndarray:
    """Render ``spp`` scan passes on the scene's device, saving the
    accumulated image to ``ckpt_path`` after every ``chunk`` passes.

    Returns the mean linear (H, W, 3) float32 image. If ``ckpt_path``
    holds a checkpoint of the same seed, image shape, spp, config and
    format, the render resumes from its pass count; anything else starts
    over. ``progress(done, spp)`` is called after every chunk.
    """
    from tinyraytracing_tpu_torch.ops.rng import fold_in, master_key_data
    from tinyraytracing_tpu_torch.render import render_pass

    key = master_key_data(seed)
    H, W = cam.height, cam.width
    acc = np.zeros((H, W, 3), np.float64)
    done = 0
    bound = dict(seed=seed, shape=(H, W, 3), spp_total=spp,
                 config=repr(config), format=SCAN_STATE_FORMAT)
    if os.path.exists(ckpt_path):
        with np.load(ckpt_path) as z:
            if all(k in z and np.array_equal(z[k], np.asarray(v))
                   for k, v in bound.items()):
                acc = z["acc"]
                done = int(z["done"])

    while done < spp:
        n = min(chunk, spp - done)
        for s in range(done, done + n):
            acc += render_pass(scene, cam, fold_in(key, s),
                               config).cpu().numpy()
        done += n
        _atomic_savez(ckpt_path, acc=acc, done=done, **bound)
        if progress:
            progress(done, spp)
    return (acc / max(done, 1)).astype(np.float32)
