"""``scene_build_s``: seconds of the harness's host clock around building
the program's scene from the raw arrays (``assemble_scene``, the native
SAH build and packing of ``attach_bvh``, the trace kernels' records),
ended by a synchronisation. Part of ``setup_s``."""


def read(obs):
    return obs.get("scene_build_s")
