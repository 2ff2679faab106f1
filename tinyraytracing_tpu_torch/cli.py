"""Command line with the flags of ``tinyraytracing_tpu/cli.py``.

Renders on the CUDA device (the hand-written kernels) unless ``--device
cpu`` asks for the CPU (their plain PyTorch versions); without a CUDA
device and without ``--device cpu`` it exits with an error. Examples:

    python -m tinyraytracing_tpu_torch.cli --scene grid:100000 \\
        --width 1024 --height 1024 --spp 4 --out /tmp/x.png
    python -m tinyraytracing_tpu_torch.cli --scene cornell \\
        --width 64 --height 64 --spp 2 --device cpu --out /tmp/c.png
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tinyraytracing_tpu_torch.cli", description=__doc__)
    p.add_argument("--basedir", default=None, help="scene base directory")
    p.add_argument("--xml", default=None, help=".xml scene config (relative to basedir unless absolute)")
    p.add_argument("--obj", default=None, help=".obj mesh path")
    p.add_argument("--mtl", default=None, help=".mtl material library path")
    p.add_argument("--scene", default=None,
                   help="procedural scene instead of files: cornell | "
                        "cornell-specular | grid:<n_triangles>")
    p.add_argument("--spp", type=int, default=256, help="samples per pixel (reference default 256)")
    p.add_argument("--max-depth", type=int, default=16)
    p.add_argument("--p-rr", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=None, help="override XML image width")
    p.add_argument("--height", type=int, default=None, help="override XML image height")
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "persistent", "queue", "scan"],
                   help="auto = queue for >= 512 triangles, else persistent; "
                        "scan = the fixed-depth wavefront with any "
                        "--intersector")
    p.add_argument("--lanes", type=int, default=262144,
                   help="wavefront width for the fused renderers")
    p.add_argument("--leaf-size", default="auto",
                   help="BVH leaf width: an int, or 'auto' (8: on an H100 "
                        "both trace kernels ran ~2x faster at 8 than at "
                        "the JAX package's 32 for >=10K triangles)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to render (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("--intersector", default="auto", choices=["auto", "mxu", "brute", "bvh", "pallas", "bvh_pallas"])
    p.add_argument("--light-sampler", default="ref", choices=["ref", "uniform"])
    p.add_argument("--specular-weight", default="ref", choices=["ref", "ks"])
    p.add_argument("--shadow-test", default="mtl", choices=["mtl", "tmin"])
    p.add_argument("--out", default=None, help="output PNG (default basedir/image<SPP>.png)")
    p.add_argument("--checkpoint", default=None,
                   help="lane-state snapshot path for resumable long renders "
                        "(queue renderer); pass with --resume to continue")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if present")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for compatibility; has no effect")
    return p


def build_scene(args):
    """(scene, camera, config) of the parsed arguments ``args``: the render
    config from the flags, the procedural or file scene on ``--device``,
    and, where the renderer needs one, a BVH built at ``--leaf-size``
    ("auto" is 8 here). The BVH is always built from the scene's float32
    vertices, as the JAX CLI builds it, so ``--scene grid:N`` renders on
    the JAX CLI's tree, not on the one ``quad_grid`` built from its float64
    mesh. Without a CUDA device and without ``--device cpu`` it exits with
    an error."""
    import torch

    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.models.scene import load_scene

    if args.scene is None and not (args.basedir and args.xml and args.obj and args.mtl):
        raise SystemExit("either --scene or all of --basedir/--xml/--obj/--mtl required")
    rel = lambda p: p if os.path.isabs(p) else os.path.join(args.basedir, p)
    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to render "
                         "on the CPU")

    config = RenderConfig(
        spp=args.spp,
        max_depth=args.max_depth,
        p_rr=args.p_rr,
        intersector=args.intersector,
        light_sampler=args.light_sampler,
        specular_weight=args.specular_weight,
        shadow_test=args.shadow_test,
    )
    # the fused renderers need the packed-leaf BVH; build it at load unless
    # the scan path was asked for with a non-BVH intersector (the JAX CLI's
    # rule, so --renderer scan --intersector bvh_pallas on a scene built
    # without a BVH raises, as there)
    with_bvh = (
        args.renderer in ("auto", "persistent", "queue")
        or config.intersector in ("auto", "bvh")
    )
    if args.scene:
        from tinyraytracing_tpu_torch.models.procedural import (
            cornell_box, cornell_box_specular, quad_grid,
        )

        if args.scene == "cornell":
            scene, cam = cornell_box(device=device)
        elif args.scene == "cornell-specular":
            scene, cam = cornell_box_specular(device=device)
        elif args.scene.startswith("grid:"):
            scene, cam = quad_grid(int(args.scene.split(":")[1]), device=device)
        else:
            raise SystemExit(f"unknown --scene {args.scene}")
    else:
        scene, cam = load_scene(
            rel(args.xml), rel(args.obj), rel(args.mtl), args.basedir,
            with_bvh=False, device=device,
        )
    if with_bvh:
        from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

        leaf = (config.leaf_size if args.leaf_size == "auto"
                else int(args.leaf_size))
        config = config.replace(leaf_size=leaf)
        scene = attach_bvh(scene, config)
    return scene, cam, config


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from tinyraytracing_tpu_torch.render import render_image
    from tinyraytracing_tpu_torch.utils.logging import get_logger
    from tinyraytracing_tpu_torch.utils.timing import Timer

    log = get_logger()
    scene, cam, config = build_scene(args)
    if args.width or args.height:
        cam = dataclasses.replace(
            cam, width=args.width or cam.width, height=args.height or cam.height
        )
    log.info(
        "scene: %d triangles, %d materials, %d lights; image %dx%d @ %d spp "
        "on %s", scene.num_triangles, scene.num_materials, scene.num_lights,
        cam.width, cam.height, args.spp, args.device,
    )
    if scene.bvh is not None:
        log.info("BVH: %d nodes, %d wide nodes", scene.bvh.n_nodes,
                 scene.bvh.packed.n_wide)

    out = args.out or os.path.join(args.basedir or ".", f"image{args.spp}.png")
    prog = lambda it, counter, seconds: log.info(
        "  chunk done: iter=%d paths_started=%d (%.1fs)", it, counter, seconds)
    sync = torch.cuda.synchronize if args.device == "cuda" else None
    with Timer(sync) as t:
        render_image(scene, cam, config, spp=args.spp, seed=args.seed,
                     out_path=out, renderer=args.renderer, lanes=args.lanes,
                     checkpoint_path=args.checkpoint, resume=args.resume,
                     progress=prog)
    n_rays = cam.width * cam.height * args.spp
    log.info("rendered %s in %.2fs (%.3g camera rays/s)", out, t.elapsed,
             n_rays / t.elapsed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
