"""Faults planted in the mesh cells' timed path, underneath the harness, as
``faults.py`` plants them for the other cells: each wraps
``core.port_mesh.inverse_problem`` for the length of a ``with`` block.

- ``stale_normals``: the mesh's shading normals are left as loaded (in the
  scene and in the tree's packed shading records), so faces shade as if
  they had not turned, and no gradient reaches the vertices through the
  normals;
- ``shuffled_vertex``: after each ``backward()``, the cotangents of 1% of
  the shared vertices' rows (at least 8) are summed into a permuted row of
  that set, as a scatter into the wrong rows would;
- ``unchanged_vertex``: the Adam update skips the shared vertex offsets
  (their gradient dropped after ``backward()``), so the mesh's state is
  left unchanged while its gradient reads sound.

The tests drive a run with each and see ``correct`` come out false; run as
a script on the card, it reads each fault's numbers at a cell's own size
(``sound`` reads a run with none):

    python3 portbench/tests/faults_mesh.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds S] [--faults sound stale_normals shuffled_vertex unchanged_vertex]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]

from core import harness, port_mesh  # noqa: E402

SHUFFLED_SHARE = 0.01


@contextlib.contextmanager
def _stale_normals():
    """The program's ``apply_params`` with the loaded shading normals put
    back into the moved scene and its packed shading records."""
    import torch
    from tinyraytracing_tpu_torch.diff import inverse

    real = inverse.apply_params

    def stale(scene, cam, p):
        s2, c2 = real(scene, cam, p)
        pk = s2.bvh.packed
        pk = dataclasses.replace(pk, PS=torch.cat([pk.PS[:4], scene.bvh.packed.PS[4:]]))
        s2 = dataclasses.replace(s2, n0=scene.n0, n1=scene.n1, n2=scene.n2,
                                 bvh=dataclasses.replace(s2.bvh, packed=pk))
        return s2, c2

    inverse.apply_params = stale
    try:
        yield
    finally:
        inverse.apply_params = real


def _shuffle(grad):
    """``grad`` (V, 3) with the rows of a fixed 1% of the vertices (at
    least 8) summed into a permutation of those rows."""
    import torch

    V = grad.shape[0]
    g = torch.Generator().manual_seed(V)
    rows = torch.randperm(V, generator=g)[:max(8, int(SHUFFLED_SHARE * V))].to(grad.device)
    dest = rows[torch.randperm(rows.numel(), generator=g).to(grad.device)]
    out = grad.clone()
    out[rows] = 0.0
    return out.index_add_(0, dest, grad[rows])


def _faulty(kind):
    def fault(real):
        def f(scene, cam, target_key, config, spp, learning_rate, kd_start, offset_start):
            step, state, loss_of = real(scene, cam, target_key, config, spp, learning_rate,
                                        kd_start, offset_start)

            def bad_step(state, key):
                params, opt = state
                opt.zero_grad(set_to_none=True)
                if kind == "stale_normals":
                    with _stale_normals():
                        loss = loss_of(state, key)
                        loss.backward()
                else:
                    loss = loss_of(state, key)
                    loss.backward()
                    g = params.shared_vertex_offset.grad
                    # Adam skips a leaf without a gradient; the gradient is
                    # put back after the update, where the check reads it
                    params.shared_vertex_offset.grad = (_shuffle(g) if kind == "shuffled_vertex"
                                                        else None)
                    opt.step()
                    if kind == "unchanged_vertex":
                        params.shared_vertex_offset.grad = g
                    return (params, opt), loss.detach()
                opt.step()
                return (params, opt), loss.detach()

            return bad_step, state, loss_of
        return f
    return fault


FAULTS = {k: _faulty(k) for k in ("stale_normals", "shuffled_vertex", "unchanged_vertex")}


def run_with_fault(spec: dict, run, bench: dict, fault: str) -> dict:
    """The run's result with ``fault`` planted (``sound``: none)."""
    if fault == "sound":
        return harness.execute(spec, run, bench)
    real = port_mesh.inverse_problem
    port_mesh.inverse_problem = FAULTS[fault](real)
    try:
        return harness.execute(spec, run, bench)
    finally:
        port_mesh.inverse_problem = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", nargs="*", default=["sound", *FAULTS])
    args = ap.parse_args(argv)
    bench = harness.load_bench()
    spec = harness.cell_spec(bench, args.workload)
    for fault in args.faults:
        for seed in args.seeds:
            run = harness.Run(cell=args.workload, config=spec["config"], traffic=spec["traffic"],
                              chips=1, seed=seed, seconds=args.seconds, trace=False,
                              device="cuda:0", t0=time.perf_counter())
            res = run_with_fault(spec, run, bench, fault)
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed,
                              "correct": res["correct"], "checks": res["checks"],
                              "seconds": run.elapsed()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
