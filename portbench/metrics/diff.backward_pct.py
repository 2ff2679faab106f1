"""``diff.backward_pct``: ``backward()``'s share of a gradient step, from
the harness's spans around the loss call, ``backward()`` and the update,
each ended by a synchronisation, summed over the traced steps."""


def read(obs):
    steps = obs.get("steps")
    if not steps:
        return None
    total = sum(sum(s) for s in steps)
    return 100.0 * sum(s[1] for s in steps) / total if total > 0 else None
