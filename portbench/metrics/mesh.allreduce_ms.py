"""``mesh.allreduce_ms``: device milliseconds of the NCCL kernels per pass
(``ncclDevKernel`` in the device trace), the largest rank's; nothing
where no rank ran one (a single rank sums nothing)."""


def read(obs):
    ranks = obs.get("rank_subs")
    if not ranks:
        return None
    per = [sum(e - s for n, s, e in r["kernels"] if "nccl" in n.lower()) / r["passes"]
           for r in ranks]
    return 1e3 * max(per) if any(per) else None
