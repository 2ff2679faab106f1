"""``mesh.refit_ms``: device milliseconds a step inside the program's span
``diff.refit``: the refit of the tree and its packed payload to the moved
mesh; the span's own kernels, those of the nested ``diff.mesh`` being
``mesh.apply_ms``'s. Each kernel of the traced steps counts for the
innermost span open when the host launched it, on the device trace's clock
(``core.span_profile``)."""


def read(obs):
    sub = obs.get("mesh_sub")
    if not sub or "diff.refit" not in sub["span_s"]:
        return None
    return 1e3 * sub["span_s"]["diff.refit"] / sub["steps"]
