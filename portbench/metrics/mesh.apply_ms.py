"""``mesh.apply_ms``: device milliseconds a step inside the program's span
``diff.mesh``: the per-vertex apply: the corners' gather, the moved faces'
Woop rows and normals, the light tables' corners. Each kernel of the
traced steps counts for the innermost span open when the host launched it,
on the device trace's clock (``core.span_profile``)."""


def read(obs):
    sub = obs.get("mesh_sub")
    if not sub or "diff.mesh" not in sub["span_s"]:
        return None
    return 1e3 * sub["span_s"]["diff.mesh"] / sub["steps"]
