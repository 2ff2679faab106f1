"""``mesh.scatter_ms``: device milliseconds a step inside the program's span
``diff.mesh.scatter``: the backward's vertex-cotangent scatter, every
corner's cotangent summed into its shared vertex (``scatter_fixed``). Each
kernel of the traced steps counts for the innermost span open when the
host launched it, on the device trace's clock (``core.span_profile``)."""


def read(obs):
    sub = obs.get("mesh_sub")
    if not sub or "diff.mesh.scatter" not in sub["span_s"]:
        return None
    return 1e3 * sub["span_s"]["diff.mesh.scatter"] / sub["steps"]
