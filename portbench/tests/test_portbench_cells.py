"""Tiny cells of each driver kind end to end on the CPU, through the
harness, against the plain reference: sound runs come out correct, the
control (the reference in bfloat16 in the program's place) and every
fault planted under the timed path come out not correct."""

import pytest
from conftest import tiny_run, tiny_spec
from core import harness

import faults

SINGLE = ["grid100k.bucket512", "cornell.pass4", "cornell.inverse"]


@pytest.mark.parametrize("cell", SINGLE)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(bench, cell, trace):
    spec = tiny_spec(bench, cell)
    res = harness.execute(spec, tiny_run(spec, cell, trace=trace), bench)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.metrics_for(bench, section, cell)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want


def test_sharded_cell_at_one_rank(bench):
    cell = "grid1m.sharded-x4"
    spec = tiny_spec(bench, cell)
    res = harness.execute(spec, tiny_run(spec, cell, world=1), bench)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"rays_per_s_x4", "setup_s", "peak_mem_mib"}


@pytest.mark.parametrize("cell", SINGLE + ["grid1m.sharded-x4"])
def test_control_is_not_correct(bench, cell):
    spec = tiny_spec(bench, cell)
    checks = harness.driver(spec["traffic"]["driver"]).control(tiny_run(spec, cell), 2)
    assert not harness.judge(checks, spec["limits"])[0], checks


FAULTS = [(cell, f) for cell in SINGLE
          for f in faults.faults_for(harness.cell_spec(harness.load_bench(), cell)
                                     ["traffic"]["driver"])]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(bench, cell, fault):
    spec = tiny_spec(bench, cell)
    res = faults.run_with_fault(spec, tiny_run(spec, cell), bench, fault)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("fault", ["exchange_left_out", "altered_image", "altered_count", "half",
                                   "unchanged"])
def test_sharded_fault_at_two_ranks(bench, fault):
    cell = "grid1m.sharded-x4"
    spec = tiny_spec(bench, cell)
    res = faults.run_with_fault(spec, tiny_run(spec, cell, world=2, seconds=0.1), bench, fault)
    assert not res["correct"], (fault, res["checks"])
