"""Scene kind ``cornell_box``: the classic, publicly documented Cornell box
(floor, ceiling, back wall, two coloured walls, the light quad coplanar
with the ceiling, the short and the tall block), 32 triangles; the same
corners, materials, light and camera as the port's
``models/procedural.py``, written out again so that neither side's scene
comes from the other."""

from core import scenes

QUADS = [
    ([(552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)], "DiffuseWhite"),
    ([(343, 548.8, 227), (343, 548.8, 332), (213, 548.8, 332), (213, 548.8, 227)], "Light"),
    ([(556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0)], "DiffuseWhite"),
    ([(549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2)], "DiffuseWhite"),
    ([(0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)], "RightWall"),
    ([(552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0)], "LeftWall"),
    ([(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)], "DiffuseWhite"),
    ([(290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)], "DiffuseWhite"),
    ([(130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)], "DiffuseWhite"),
    ([(82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)], "DiffuseWhite"),
    ([(240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)], "DiffuseWhite"),
    ([(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)], "DiffuseWhite"),
    ([(423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)], "DiffuseWhite"),
    ([(472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)], "DiffuseWhite"),
    ([(314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)], "DiffuseWhite"),
    ([(265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)], "DiffuseWhite"),
]
BOX, LIGHT = [QUADS[i] for i in (0, 2, 3, 4, 5)], QUADS[1]

_DIFFUSE = dict(ks=(0.0, 0.0, 0.0), tr=(1.0, 1.0, 1.0), ns=1.0, ni=1.0)
MATERIALS = {
    "DiffuseWhite": dict(kd=(0.79, 0.76, 0.73), **_DIFFUSE),
    "LeftWall": dict(kd=(0.0, 0.24, 0.9), **_DIFFUSE),
    "RightWall": dict(kd=(0.2, 0.76, 0.0), **_DIFFUSE),
    "Light": dict(kd=(0.0, 0.0, 0.0), **_DIFFUSE),
}
LIGHTS = [("Light", (34.0, 24.0, 8.0))]


def camera(width: int, height: int) -> dict:
    return dict(eye=(278.0, 273.0, -800.0), lookat=(278.0, 273.0, -799.0),
                up=(0.0, 1.0, 0.0), fovy=39.3077, width=int(width), height=int(height))


def build(width: int, height: int) -> dict:
    names: list[str] = []
    v, mtl = scenes.quads(QUADS, names)
    return scenes.finish(v, mtl, names, MATERIALS, LIGHTS, camera(width, height))
