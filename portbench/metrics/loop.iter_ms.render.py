"""``loop.iter_ms.render``: milliseconds per iteration of a fused render loop
(moves ``rays_per_s``): the traced unit's wall time over its closest-hit
trace launches, one an iteration (kernel names ``trace_kernel<false, ...>``
in the device trace); ``core.profiling.iter_ms``."""

from core import profiling


def read(obs):
    return profiling.iter_ms(obs.get("render_sub"))
