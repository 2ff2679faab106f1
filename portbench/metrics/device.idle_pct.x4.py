"""``device.idle_pct.x4``: each rank's idle share over its traced pass (100
minus the union of its kernel intervals over the pass's wall time), the
largest rank's."""

from core import profiling


def read(obs):
    ranks = obs.get("rank_subs")
    if not ranks:
        return None
    idle = [profiling.idle_pct(r["kernels"], r["wall_s"]) for r in ranks]
    idle = [x for x in idle if x is not None]
    return max(idle) if idle else None
