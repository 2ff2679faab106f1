"""Every configuration, traffic mix, driver, limit file and per-layer
metric that BENCHMARK.json names is found by its name, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest
from conftest import BENCH
from core import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_each_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        spec = harness.cell_spec(bench, w["name"])
        assert spec["config"]["name"] == w["config"]
        drv = harness.driver(spec["traffic"]["driver"])
        assert callable(drv.run) and callable(drv.control)
        assert set(spec["limits"]) and all(v > 0 for v in spec["limits"].values())


def test_each_config_finds_its_scene_kind(bench):
    from core import scenes

    for c in bench["configs"]:
        conf = json.loads((BENCH.parent / c["file"]).read_text())
        kind = conf["scene"]["kind"]
        assert (BENCH / "scenes" / f"{kind}.py").exists(), kind
        assert callable(scenes.kind(kind).build)


def test_a_scene_kind_is_found_by_name(tmp_path, monkeypatch):
    """A configuration whose scene kind is a file of its own builds through
    ``scenes/<kind>.py`` alone: a later configuration adds files only."""
    from core import harness, scenes

    bench_dir = tmp_path / "portbench"
    (bench_dir / "scenes").mkdir(parents=True)
    (bench_dir / "scenes" / "one_quad.py").write_text(
        "from core import scenes\n"
        "box = scenes.kind('cornell_box')\n"
        "def build(width, height, y):\n"
        "    v, m = scenes.quads([([(0, y, 0), (1, y, 0), (1, y, 1), (0, y, 1)],\n"
        "                          'Light')], names := [])\n"
        "    return scenes.finish(v, m, names, box.MATERIALS, box.LIGHTS,\n"
        "                         box.camera(width, height))\n")
    (bench_dir / "scenes" / "cornell_box.py").write_text(
        (BENCH / "scenes" / "cornell_box.py").read_text())
    monkeypatch.setattr(harness, "BENCH_DIR", bench_dir)
    raw = scenes.build({"scene": {"kind": "one_quad", "y": 2.0}, "width": 8, "height": 4})
    assert raw["v"].shape == (2, 3, 3) and raw["v"][0, 0, 1] == 2.0
    assert raw["camera"]["width"] == 8 and raw["mtl_names"] == ["Light"]


def test_each_metric_finds_its_reader(bench):
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert harness.read_layer_metric(m["name"], {}) is None


def test_configs_state_what_was_reduced(bench):
    for c in bench["configs"]:
        conf = json.loads((BENCH.parent / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        assert c["file"].startswith("portbench/")


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    cells = {w["name"]: w for w in bench["workloads"]}
    assert len(cells) == len(bench["workloads"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
    for cell in cells:
        assert len(harness.metrics_for(bench, "end_to_end", cell)) >= 2
        assert harness.metrics_for(bench, "per_layer", cell)
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("limits", [{"a": 1.0}, {"a": 1.0, "b": 2.0}])
def test_judge_needs_every_number_under_its_limit(limits):
    ok, out = harness.judge({"a": 0.5, "b": 1.0}, limits)
    assert ok == (set(limits) == {"a", "b"})
    assert harness.judge({"a": 2.0}, {"a": 1.0})[0] is False
    assert harness.judge({"a": float("nan")}, {"a": 1.0})[0] is False
