"""The port's scan renderer against the JAX package's on
``quad_grid(600)``: the grid600 cases of ``SCAN_CASES`` (every intersector
backend, and 3 ray chunks with the last one padded), rendered with the
two packages' arithmetic aligned in a process of its own and held as
tests/test_torch_scan_render.py holds the cornell cases.
"""

import pytest

from tests.test_torch_scan_render import check_scan_case
from tests.torch_aligned_render import SCAN_CASES, run_processes


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    return run_processes(str(tmp_path_factory.mktemp("aligned_scan_grid")),
                         ["scan:grid600"])


@pytest.mark.parametrize("cfg", [c for n, c in SCAN_CASES if n == "grid600"])
def test_scan_render_matches_jax(cfg, aligned):
    check_scan_case(aligned, "grid600", cfg)
