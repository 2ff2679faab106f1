"""Pieces every driver shares: device synchronisation and memory, the
result's ``device`` entry, the renderers' pixel order, sampling from the
seed, and the reference's options from a configuration."""

from __future__ import annotations

import gc

import numpy as np
import torch

# the renderers' acceptance rule and tie band (RenderConfig's defaults)
T_MIN, N_DOT_D_MIN, TIE_EPS = 5e-4, 1e-5, 4e-6


def is_cuda(dev) -> bool:
    return torch.device(dev).type == "cuda"


def sync(dev) -> None:
    if is_cuda(dev):
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if is_cuda(dev) else 0


def settle(dev) -> None:
    """The end of set-up: what set-up left for the garbage collector is
    collected and set aside, so that no collection of it falls in the
    window, and the peak memory counter starts afresh."""
    gc.collect()
    gc.freeze()
    if is_cuda(dev):
        torch.cuda.reset_peak_memory_stats(dev)


def device_entry(dev, count: int, memory_peak: int, traced: dict | None = None) -> dict:
    """The result's ``device``: with a traced window, its busy and wall seconds."""
    cuda = is_cuda(dev)
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "count": count, "memory_peak_bytes": int(memory_peak)}
    if traced is not None:
        out["busy_s"], out["window_s"] = traced["busy_s"], traced["window_s"]
    return out


def tile_order(W: int, H: int, tile: int = 32) -> np.ndarray:
    """The renderers' pixel order: 32x32 tiles in row-major tile order,
    row-major inside each; order[slot] = pixel."""
    ys, xs = np.mgrid[0:H, 0:W]
    key = (((ys // tile) * ((W + tile - 1) // tile) + (xs // tile)).ravel() * (tile * tile)
           + (ys % tile).ravel() * tile + (xs % tile).ravel())
    return np.argsort(key, kind="stable").astype(np.int64)


def sampler(seed: int, *tags: int) -> np.random.Generator:
    """A generator for what a run samples, a function of the seed and tags."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *map(int, tags)]))


def ref_opts(config: dict) -> dict:
    return dict(max_depth=int(config["max_depth"]), p_rr=float(config["p_rr"]),
                t_min=T_MIN, n_dot_d_min=N_DOT_D_MIN, tie_eps=TIE_EPS)


def image_gap(prog, ref) -> float:
    """Relative L1 gap of the program's pixel values to the reference's."""
    prog, ref = torch.as_tensor(prog).double(), torch.as_tensor(ref).double()
    return float((prog - ref).abs().sum() / ref.abs().sum().clamp_min(1e-30))


def count_gap(prog_rays: float, prog_paths: int, ref_rays) -> float:
    """Relative gap of the program's traced rays per path (over all its
    paths) to the reference's mean over a sample of the same paths."""
    ref = float(torch.as_tensor(ref_rays).double().mean())
    return abs(prog_rays / prog_paths - ref) / max(ref, 1e-30)
