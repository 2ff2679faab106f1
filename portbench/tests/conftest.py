"""The benchmark's CPU tests: tiny cells of each driver kind, built from
the committed configuration, traffic and limit files with their sizes cut
to what the CPU holds."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from core import harness  # noqa: E402

# per cell: (configuration overrides, traffic overrides); the checks read
# every path of a unit for the count, so a sound tiny run compares exactly
TINY = {
    "grid100k.bucket512": (
        {"scene": {"kind": "quad_grid", "triangles": 400, "grid_seed": 0},
         "width": 32, "height": 32},
        {"spp": 8, "lanes": 2048, "bucket_pixels": 256,
         "check": {"buckets": 2, "pixels_per_bucket": 8, "count_buckets": 1,
                   "count_paths_per_bucket": 2048}}),
    "cornell.pass4": (
        {}, {"width": 32, "height": 32, "spp": 2, "lanes": 1024,
             "check": {"pixels": 64, "count_passes": 1, "count_paths_per_pass": 2048}}),
    "cornell.inverse": ({}, {"width": 48, "height": 48}),
    "grid1m.sharded-x4": (
        {"scene": {"kind": "quad_grid", "triangles": 400, "grid_seed": 0},
         "width": 32, "height": 32},
        {"spp": 2, "lanes": 1024,
         "check": {"passes": 2, "pixels_per_pass": 16, "count_passes": 2,
                   "count_paths_per_pass": 2048}}),
}


@pytest.fixture(scope="session")
def bench():
    return harness.load_bench()


def tiny_spec(bench, cell):
    spec = copy.deepcopy(harness.cell_spec(bench, cell))
    conf, traffic = TINY[cell]
    spec["config"].update(copy.deepcopy(conf))
    for k, v in traffic.items():
        spec["traffic"][k] = copy.deepcopy(v)
    return spec


def tiny_run(spec, cell, seed=2**31 + 12345, seconds=0.2, trace=False, world=None):
    return harness.Run(cell=cell, config=spec["config"], traffic=spec["traffic"],
                       chips=world or 1, seed=seed, seconds=seconds, trace=trace,
                       device="cpu", t0=time.perf_counter(), world=world or 1)


@pytest.fixture
def card():
    """Skips a test here unless the process sees a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
