"""XML scene-config parser.

Parses the course scene format (reference spec:
RayTracingOnCPU/example-scenes-cg22/README.md):

    <camera type="perspective" width="W" height="H" fovy="F">
        <eye x= y= z= /> <lookat x= y= z= /> <up x= y= z= />
    </camera>
    <light mtlname="..." radiance="r, g, b" />  (0..N, SIBLINGS of <camera>)

The files are NOT well-formed single-root XML — ``<light>`` elements are
siblings of ``<camera>`` at top level (tinyxml2 tolerates this; the reference
walks ``NextSiblingElement``, RayTracingOnCPU/scene.cpp:24-54). We wrap the
document in a synthetic root so stdlib ElementTree can parse it.

Radiance strings may contain spaces and newlines between the commas (e.g.
staircase.xml's multi-line radiances); the reference's hand-rolled comma
splitter (scene.cpp:30-49) handles this via stof's whitespace skipping — a
plain ``split(',')`` + ``float`` does the same here.
"""

from __future__ import annotations

import dataclasses
import re
from xml.etree import ElementTree


@dataclasses.dataclass
class LightSpec:
    mtl_name: str
    radiance: tuple[float, float, float]


@dataclasses.dataclass
class SceneConfig:
    width: int
    height: int
    fovy: float
    eye: tuple[float, float, float]
    lookat: tuple[float, float, float]
    up: tuple[float, float, float]
    lights: list[LightSpec]


def _vec3_attrs(el) -> tuple[float, float, float]:
    return (float(el.attrib["x"]), float(el.attrib["y"]), float(el.attrib["z"]))


def parse_scene_xml(path: str) -> SceneConfig:
    """Parse a scene XML file into a SceneConfig.

    Mirrors Scene::readxml (reference: RayTracingOnCPU/scene.cpp:3-55):
    camera intrinsics/extrinsics from the <camera> element, one LightSpec per
    <light> element in document order (order matters — the reference's NEE
    draws its light-pick uniform from the FIRST light's area, see config.py).
    """
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    # strip the XML declaration and wrap in a synthetic root: the scene files
    # have multiple top-level elements.
    text = re.sub(r"<\?xml[^>]*\?>", "", text)
    root = ElementTree.fromstring(f"<scene>{text}</scene>")

    cam = root.find("camera")
    if cam is None:
        raise ValueError(f"{path}: no <camera> element")

    lights = []
    for el in root.findall("light"):
        parts = el.attrib["radiance"].split(",")
        if len(parts) != 3:
            raise ValueError(f"{path}: bad radiance {el.attrib['radiance']!r}")
        lights.append(
            LightSpec(
                mtl_name=el.attrib["mtlname"],
                radiance=tuple(float(p) for p in parts),
            )
        )

    return SceneConfig(
        width=int(cam.attrib["width"]),
        height=int(cam.attrib["height"]),
        fovy=float(cam.attrib["fovy"]),
        eye=_vec3_attrs(cam.find("eye")),
        lookat=_vec3_attrs(cam.find("lookat")),
        up=_vec3_attrs(cam.find("up")),
        lights=lights,
    )
