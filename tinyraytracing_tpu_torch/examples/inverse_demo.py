"""Inverse rendering on the FAST path: recover the Cornell box's wall
albedos from a target image by gradient descent through the trace
kernels (``diff.fast``: path replay under a custom backward), the
counterpart of the repository's ``examples/inverse_demo.py``.

The target is ``render_diff`` at 4 spp with the true albedos; every
albedo starts at 0.5 and takes Adam steps (lr 0.05) of
``render_loss_fast`` through ``diff.inverse.make_train_step``
(``torch.optim.Adam``: optax.adam's update, eps_root 0); step i draws its
samples from ``fold_in(key, i)``. On the card the forward and the
backward's recompute run trace kernels 1 and 2 and the cotangent
scatters the fixed-order kernel.

    python -m tinyraytracing_tpu_torch.examples.inverse_demo [steps] \\
        [resolution] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.diff.fast import render_diff, render_loss_fast
from tinyraytracing_tpu_torch.diff.inverse import SceneParams, make_train_step
from tinyraytracing_tpu_torch.models.procedural import cornell_box
from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
from tinyraytracing_tpu_torch.ops.rng import fold_in, master_key_data

CONFIG = RenderConfig(intersector="bvh", max_depth=4)
SPP = 4


def recover_albedo(steps: int = 40, res: int = 64, device: str = "cuda",
                   print_every: int = 10):
    """Run the Adam steps; returns (log, recovered kd, true kd). The log
    has one dict per step: ``step``, ``loss`` (before the step) and
    ``kd_max_err`` (after it, over the non-emissive materials: emitters
    never use kd)."""
    scene, cam = cornell_box(width=res, height=res, device=device)
    scene = attach_bvh(scene, CONFIG)
    key = master_key_data(0)
    with torch.no_grad():
        target = render_diff(scene, cam, key, CONFIG, SPP)
    step, init = make_train_step(scene, cam, target, CONFIG, SPP,
                                 learning_rate=0.05, loss_fn=render_loss_fast)
    state = init(SceneParams(kd=torch.full_like(scene.kd, 0.5)))  # wrong albedos
    obs = ~scene.mtl_emissive
    log = []
    for i in range(steps):
        state, loss = step(state, fold_in(key, i))
        kd = state[0].kd.detach()
        err = float((kd - scene.kd).abs()[obs].max())
        log.append(dict(step=i, loss=float(loss), kd_max_err=err))
        if print_every and (i % print_every == 0 or i == steps - 1):
            print(f"step {i:3d}: loss {float(loss):.6f}  max|kd err| {err:.4f}")
    return log, state[0].kd.detach(), scene.kd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", type=int, nargs="?", default=40)
    ap.add_argument("resolution", type=int, nargs="?", default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="default cuda; cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to run on "
                         "the CPU")
    _, kd, kd_true = recover_albedo(args.steps, args.resolution, args.device)
    print("true kd[:3]:", kd_true[:3].cpu().numpy())
    print("recovered  :", kd[:3].cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
