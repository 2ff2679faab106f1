"""``diff.step_ms_p90.mesh``: the 90th percentile of the mesh cell's window
steps (loss call, ``backward()``, Adam update, a synchronisation), in ms,
on the harness's host clock: ``diff.step_ms_p90``'s reading of this
cell's steps."""

from core import harness


def read(obs):
    return harness.read_layer_metric("diff.step_ms_p90", obs)
