"""Inverse-rendering demo (BASELINE.json config 4) on the port: recover
the Cornell box's material albedos by pixel-gradient descent, the
counterpart of the repository's ``examples/inverse_rendering.py``.

Renders a target image with the true albedos, perturbs them, then
descends the MSE pixel loss of the scan renderer (``diff.inverse.
render_loss``, path-replay gradients) with plain gradient steps. Writes
target / initial / recovered renders and a JSON log of the loss and the
albedo error per step. On the card the scan renderer's "mxu" intersector
is plain PyTorch (as in the JAX package); the backward's cotangent
scatters run the fixed-order kernel (``ops/scatter.py``).

    python -m tinyraytracing_tpu_torch.examples.inverse_rendering \\
        [--steps 60] [--size 48] [--spp 4] [--lr 5.0] [--out DIR] \\
        [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.diff.inverse import SceneParams, render_loss
from tinyraytracing_tpu_torch.io.image import write_png
from tinyraytracing_tpu_torch.models.procedural import cornell_box
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.render import render

CONFIG = RenderConfig(intersector="mxu", max_depth=4, tri_chunk=64)


def recover_albedo(steps: int = 60, size: int = 48, spp: int = 4,
                   lr: float = 5.0, out: str | None = None,
                   device: str = "cuda", print_every: int = 10):
    """Run the descent; returns its log, one dict per step (``step``,
    ``loss`` before the step, ``kd_max_err`` after it: the largest
    absolute albedo error over the non-emissive materials). With ``out``,
    writes target.png, initial.png, recovered.png and log.json there."""
    scene, cam = cornell_box(width=size, height=size, device=device)
    key = master_key_data(0)
    with torch.no_grad():
        target = render(scene, cam, key, CONFIG, spp)
    kd_true = scene.kd
    kd = kd_true * 0.4 + 0.25                  # perturbed start
    # emissive materials' Kd is unobservable (emissive hits return
    # radiance directly): excluded from the recovery error
    observable = ~scene.mtl_emissive
    if out is not None:
        os.makedirs(out, exist_ok=True)
        write_png(f"{out}/target.png", target.cpu().numpy())
        with torch.no_grad():
            init = render(dataclasses.replace(scene, kd=kd), cam, key, CONFIG, spp)
        write_png(f"{out}/initial.png", init.cpu().numpy())
    log = []
    for step in range(steps):
        # target and render share the key: the Monte-Carlo noise cancels
        # in the residual, so the loss floor is 0 and descent is exact
        kd = kd.detach().requires_grad_(True)
        loss = render_loss(SceneParams(kd=kd), scene, cam, key, target,
                           CONFIG, spp)
        loss.backward()
        kd = (kd - lr * kd.grad).detach()
        err = float((kd - kd_true).abs()[observable].max())
        log.append(dict(step=step, loss=float(loss.detach()), kd_max_err=err))
        if print_every and step % print_every == 0:
            print(f"step {step:3d}  loss {log[-1]['loss']:.6f}  |kd err| {err:.4f}")
    if out is not None:
        with torch.no_grad():
            rec = render(dataclasses.replace(scene, kd=kd), cam, key, CONFIG, spp)
        write_png(f"{out}/recovered.png", rec.cpu().numpy())
        with open(f"{out}/log.json", "w") as f:
            json.dump(log, f, indent=1)
    return log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5.0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "inverse_rendering"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="default cuda; cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to run on "
                         "the CPU")
    log = recover_albedo(args.steps, args.size, args.spp, args.lr, args.out,
                         args.device)
    if log:
        print(f"final loss {log[-1]['loss']:.6f}, kd max err "
              f"{log[-1]['kd_max_err']:.4f}")
    print(f"outputs in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
