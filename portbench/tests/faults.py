"""Faults planted in the timed path, underneath the harness: each replaces
one of the program's entry points in ``core.port`` for the length of a
``with`` block. The tests drive a run with each and see ``correct`` come
out false; run as a script on the card, it reads each fault's numbers at
a cell's own size:

    python3 portbench/tests/faults.py --workload <cell> --seeds <n> [<n> ...] [--seconds S]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]

from core import harness, port  # noqa: E402


@contextlib.contextmanager
def patched(name, fn):
    real = getattr(port, name)
    setattr(port, name, fn(real))
    try:
        yield
    finally:
        setattr(port, name, real)


def _render_faults(name, spp_arg):
    """Faults of a render entry point ``name`` whose spp is positional
    argument ``spp_arg``."""

    def unchanged(real):           # the image it was handed, never added into
        def f(*a, **k):
            img, rays = real(*a, **k)
            return img.zero_(), rays
        return f

    def half(real):                # half the samples, the mean over the rest
        def f(*a, **k):
            a = list(a)
            a[spp_arg] = max(1, a[spp_arg] // 2)
            img, rays = real(*a, **k)
            return img, rays * 2
        return f

    def altered_image(real):
        def f(*a, **k):
            img, rays = real(*a, **k)
            return img * 1.05, rays
        return f

    def altered_count(real):
        def f(*a, **k):
            img, rays = real(*a, **k)
            return img, rays * 1.1
        return f

    return {k: (name, v) for k, v in dict(unchanged=unchanged, half=half,
                                           altered_image=altered_image,
                                           altered_count=altered_count).items()}


def _queue_half(real):
    """The bucket's first half of paths only, its count taken for the whole."""
    def f(scene, cam, key, config, spp, lanes, path_lo, n_paths):
        img, rays = real(scene, cam, key, config, spp, lanes, path_lo, n_paths // 2)
        return img, rays * 2
    return f


def _exchange_left_out(real):
    """Rank 0 keeps its own share: it takes part in the sum and drops it."""
    def f(scene, cam, key, config, spp, mesh, lanes):
        from tinyraytracing_tpu_torch.parallel.mesh import _queue_share

        img, rays = _queue_share(scene, cam, key, config, spp, lanes, mesh.size, mesh.rank)
        mesh.all_reduce(img), mesh.all_reduce(rays)
        return img.reshape(cam.height, cam.width, 3), rays * mesh.size
    return f


def _inverse(kind):
    """A training step that leaves the state unchanged, takes the loss over
    half the image's rows, or alters the loss (and so its gradients)."""
    def fault(real):
        def f(scene, cam, target_key, config, spp, learning_rate, kd_start):
            import torch
            from tinyraytracing_tpu_torch.diff.fast import render_diff
            from tinyraytracing_tpu_torch.diff.inverse import apply_params

            step, state, loss_of = real(scene, cam, target_key, config, spp, learning_rate,
                                        kd_start)
            with torch.no_grad():
                target = render_diff(scene, cam, target_key, config, spp)
            rows = cam.height // 2

            def loss_half(params, key):
                s2, c2 = apply_params(scene, cam, params)
                img = render_diff(s2, c2, key, config, spp)
                return torch.mean((img[:rows] - target[:rows]) ** 2)

            def bad_step(state, key):
                params, opt = state
                opt.zero_grad(set_to_none=True)
                loss = loss_half(params, key) if kind == "half" else loss_of(state, key)
                if kind == "altered":
                    loss = loss * 1.05
                loss.backward()
                if kind != "unchanged":
                    opt.step()
                return (params, opt), loss.detach()

            return bad_step, state, loss_of
        return f
    return ("inverse_problem", fault)


def faults_for(driver_kind: str) -> dict:
    """{fault name: (entry point name, wrapper)} of a driver kind."""
    if driver_kind == "queue_buckets":
        out = _render_faults("render_queue_slice", 4)
        out["half"] = ("render_queue_slice", _queue_half)   # spp is fixed by the slice
        return out
    if driver_kind == "progressive":
        return _render_faults("render_persistent", 4)
    if driver_kind == "sharded_queue":
        out = _render_faults("render_sharded_queue", 4)
        out["exchange_left_out"] = ("render_sharded_queue", _exchange_left_out)
        return out
    if driver_kind == "inverse_steps":
        return {k: _inverse(k) for k in ("unchanged", "half", "altered")}
    raise KeyError(driver_kind)


def run_with_fault(spec: dict, run, bench: dict, fault: str) -> dict:
    name, fn = faults_for(spec["traffic"]["driver"])[fault]
    with patched(name, fn):
        return harness.execute(spec, run, bench)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", nargs="*")
    args = ap.parse_args(argv)
    bench = harness.load_bench()
    spec = harness.cell_spec(bench, args.workload)
    names = args.faults or list(faults_for(spec["traffic"]["driver"]))
    for fault in names:
        for seed in args.seeds:
            run = harness.Run(cell=args.workload, config=spec["config"], traffic=spec["traffic"],
                              chips=1, seed=seed, seconds=args.seconds, trace=False,
                              device="cuda:0", t0=time.perf_counter())
            res = run_with_fault(spec, run, bench, fault)
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed,
                              "correct": res["correct"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
