"""``mesh_kernels_roofline``: the share of the trace kernels' and the vertex
scatter's device time in the traced mesh gradient steps that the least
time for their work would take on an H100 (3.35 TB/s of HBM; the
operations bound is far below). The work is counted from the entry
points, each byte once (PERF.md §3 and §6):

- the trace kernels (``csrc/trace.cu``) run twice a step, in the forward
  and in the backward's checkpoint recompute: each ray of the forward's
  ``diff.rays`` (closest hit and shadow) read (24 B) and its result
  written (4 B) once a run, and the scene's triangle corners read once a
  launch (36 B a triangle);
- the vertex scatter (``scatter_fixed``, the kernels launched inside
  ``diff.mesh.scatter``): each corner's row id (4 B) and cotangent (12 B)
  read once, three corners a triangle, and each shared vertex's row read
  and written once (24 B).

Being a lower bound on the time, the share cannot pass 100%. Nothing is
read where the traced steps ran no trace kernel or the scatter's span
holds no kernel."""

from core.profiling import HBM_BYTES_PER_S, RAY_BYTES, TRIANGLE_BYTES

CORNER_BYTES, VERTEX_BYTES = 16, 24
RUNS = 2                  # forward and checkpoint recompute


def trace_bytes(rays, launches, triangles):
    return RUNS * rays * RAY_BYTES + launches * triangles * TRIANGLE_BYTES


def scatter_bytes(steps, triangles, vertices):
    return steps * (3 * triangles * CORNER_BYTES + vertices * VERTEX_BYTES)


def read(obs):
    sub = obs.get("mesh_sub")
    if not sub or not sub["trace_launches"] or not sub["span_s"].get("diff.mesh.scatter"):
        return None
    device_s = sub["trace_s"] + sub["span_s"]["diff.mesh.scatter"]
    need = (trace_bytes(sub["rays"], sub["trace_launches"], sub["triangles"])
            + scatter_bytes(sub["steps"], sub["triangles"], sub["vertices"]))
    return 100.0 * need / HBM_BYTES_PER_S / device_s
