"""Host-side scene I/O: XML camera/light config, OBJ meshes, MTL materials,
texture images, and PNG image output.

Plain Python and numpy, identical to ``tinyraytracing_tpu.io`` (which the
port cannot import: that package's ``__init__`` pulls in jax).
"""

from tinyraytracing_tpu_torch.io.xmlscene import SceneConfig, LightSpec, parse_scene_xml
from tinyraytracing_tpu_torch.io.mtl import MaterialSpec, parse_mtl
from tinyraytracing_tpu_torch.io.objmesh import MeshArrays, parse_obj
from tinyraytracing_tpu_torch.io.textures import load_texture_atlas
from tinyraytracing_tpu_torch.io.image import write_png, tonemap_srgb

__all__ = [
    "SceneConfig",
    "LightSpec",
    "parse_scene_xml",
    "MaterialSpec",
    "parse_mtl",
    "MeshArrays",
    "parse_obj",
    "load_texture_atlas",
    "write_png",
    "tonemap_srgb",
]
