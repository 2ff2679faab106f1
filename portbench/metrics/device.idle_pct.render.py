"""``device.idle_pct.render``: 100 minus the union of the device's kernel
intervals over the traced unit's wall time (moves ``rays_per_s``)."""

from core import profiling


def read(obs):
    return profiling.unit_idle_pct(obs.get("render_sub"))
