"""``device.idle_pct.inverse``: 100 minus the union of the device's kernel
intervals over the traced gradient steps' wall time."""

from core import profiling


def read(obs):
    sub = obs.get("inverse_sub")
    return profiling.idle_pct(sub["kernels"], sub["wall_s"]) if sub else None
