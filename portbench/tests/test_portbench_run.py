"""The command as the benchmark runs it: what it loads, and how it ends
where it cannot run."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
from conftest import BENCH

ROOT = BENCH.parent
RUN = [sys.executable, "portbench/run.py", "--workload", "cornell.pass4", "--seed",
       str(2**31 + 3), "--seconds", "2", "--trace", "0"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_nothing_of_the_jax_stack_is_loaded(tmp_path):
    """A tiny cell driven through the harness, with every per-layer reader,
    leaves no module whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: the port's name starts with the latter's)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(ROOT)!r}]
        from conftest import tiny_run, tiny_spec
        from core import harness
        bench = harness.load_bench()
        for cell in ("cornell.pass4", "grid100k.bucket512"):
            spec = tiny_spec(bench, cell)
            harness.execute(spec, tiny_run(spec, cell, trace=True), bench)
        print(harness.forbidden_loaded())
        print(sorted(m for m in sys.modules if m.split(".")[0] == "tinyraytracing_tpu_torch")[:1])
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] != "[]"          # the port itself was loaded


def test_a_worker_rank_that_loads_the_jax_package_fails_the_run(bench, tmp_path, monkeypatch,
                                                                 capfd):
    """The sharded cell at two ranks on the CPU, with the JAX package planted
    in the worker rank's process alone (a ``sitecustomize`` on its path):
    the worker exits with an error naming it, and rank 0 fails the run."""
    from conftest import tiny_run, tiny_spec
    from core import harness

    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\n"
        "sys.modules['tinyraytracing_tpu'] = types.ModuleType('tinyraytracing_tpu')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    cell = "grid1m.sharded-x4"
    spec = tiny_spec(bench, cell)
    with pytest.raises(RuntimeError, match="a worker rank failed"):
        harness.execute(spec, tiny_run(spec, cell, world=2, seconds=0.1), bench)
    assert "rank 1: modules of the JAX stack were loaded: ['tinyraytracing_tpu']" in \
        capfd.readouterr().err
    assert "tinyraytracing_tpu" not in harness.forbidden_loaded()


def test_forbidden_names_are_compared_whole(monkeypatch):
    from core import harness

    monkeypatch.setitem(sys.modules, "tinyraytracing_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_loaded() == ["jax"]


def test_without_a_card_it_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this process sees a CUDA device")
    out = subprocess.run(RUN, cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_bench_files_alone_do_not_run(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's own files
    (no program) exits with an error and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(RUN, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run(RUN, cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
