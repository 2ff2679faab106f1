"""Distribution over ranks of ``torch.distributed``, the counterpart of
``tinyraytracing_tpu/parallel/``: a (tile, spp) mesh of ranks — pixel
tiles on one axis, sample passes on the other, the scene replicated on
every rank — and collectives that sum the spp axis and gather the tiles.
The caller starts one process per rank and initialises the process
group; several ranks on one card need gloo."""

from tinyraytracing_tpu_torch.parallel.mesh import make_mesh, render_sharded

__all__ = ["make_mesh", "render_sharded"]
