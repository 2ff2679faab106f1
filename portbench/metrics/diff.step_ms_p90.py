"""``diff.step_ms_p90``: the 90th percentile of the window's gradient
steps (loss call, ``backward()``, Adam update, a synchronisation), in ms,
on the harness's host clock: every step of the window, none left out."""

import statistics


def read(obs):
    times = obs.get("step_times")
    if not times:
        return None
    return 1e3 * (statistics.quantiles(times, n=10)[-1] if len(times) > 1 else times[0])
