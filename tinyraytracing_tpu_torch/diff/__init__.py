"""Differentiable rendering, the counterpart of ``tinyraytracing_tpu/diff/``:
pixel gradients with respect to material albedo, light radiance, vertex
positions and camera pose by path replay (sampling decisions detached,
contribution terms differentiated: ``config.detach_sampling``).

Two of the JAX package's three layers are ported:

- ``diff/inverse.py``: ``SceneParams`` / ``apply_params`` / ``render_loss``
  over the fixed-depth scan renderer, and ``make_train_step`` (Adam);
- ``diff/fast.py``: the fast path, ``fused_trace_diff`` (the trace kernels
  forward, closed-form Moller-Trumbore replay backward), ``render_diff``
  and ``render_loss_fast``; ``apply_params`` refits the BVH under vertex
  offsets (``diff/refit.py``) instead of dropping it.

The third, the edge-sampled boundary terms of ``diff/edge.py``, is not
ported yet; ``render_loss_fast`` raises where they are asked for.
"""

from tinyraytracing_tpu_torch.diff.fast import (
    fused_trace_diff,
    render_diff,
    render_loss_fast,
)
from tinyraytracing_tpu_torch.diff.inverse import (
    SceneParams,
    apply_params,
    make_train_step,
    render_loss,
)

__all__ = [
    "SceneParams", "apply_params", "render_loss", "make_train_step",
    "fused_trace_diff", "render_diff", "render_loss_fast",
]
