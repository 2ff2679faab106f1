"""``render_kernels_roofline``: the share of the hand-written trace and
scatter kernels' device time that the least time for their work would
take on an H100, in the traced unit (moves ``rays_per_s``). The work is
counted from the entry point; ``core.profiling`` says how, and why the
share cannot pass 100%."""

from core import profiling


def read(obs):
    return profiling.kernels_roofline_pct(obs.get("render_sub"))
