"""``device.idle_pct.mesh``: 100 minus the union of the device's kernel
intervals over the traced mesh gradient steps' wall time."""

from core import profiling


def read(obs):
    sub = obs.get("mesh_sub")
    return profiling.idle_pct(sub["kernels"], sub["wall_s"]) if sub else None
