"""MTL material-library parser.

Line-based parse of ``newmtl / Kd / Ks / Tr / Ns / Ni / map_Kd`` records into
a name->MaterialSpec dict, mirroring Scene::readmtl (reference:
RayTracingOnCPU/scene.cpp:57-113). Defaults match the reference Material
class (RayTracingOnCPU/material.h:18-23): Kd=Ks=Tr=(0,0,0), Ns=1, Ni=1.

Faithfulness note: ``test/back.mtl`` uses the non-standard key ``Kt`` which
the reference parser silently ignores (only ``Tr`` is handled) — so those
materials keep Tr=(0,0,0). We replicate that by default; pass
``kt_as_tr=True`` to treat Kt as an alias for Tr.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MaterialSpec:
    name: str
    kd: tuple[float, float, float] = (0.0, 0.0, 0.0)
    ks: tuple[float, float, float] = (0.0, 0.0, 0.0)
    tr: tuple[float, float, float] = (0.0, 0.0, 0.0)
    ns: float = 1.0
    ni: float = 1.0
    map_kd: str = ""  # absolute-or-basedir-relative texture path, "" = none


def parse_mtl(path: str, *, kt_as_tr: bool = False) -> dict[str, MaterialSpec]:
    materials: dict[str, MaterialSpec] = {}
    cur: MaterialSpec | None = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            key = tok[0]
            if key == "newmtl":
                cur = materials.setdefault(tok[1], MaterialSpec(name=tok[1]))
            elif cur is None:
                continue
            elif key == "Kd":
                cur.kd = (float(tok[1]), float(tok[2]), float(tok[3]))
            elif key == "Ks":
                cur.ks = (float(tok[1]), float(tok[2]), float(tok[3]))
            elif key == "Tr" or (kt_as_tr and key == "Kt"):
                cur.tr = (float(tok[1]), float(tok[2]), float(tok[3]))
            elif key == "Ns":
                cur.ns = float(tok[1])
            elif key == "Ni":
                cur.ni = float(tok[1])
            elif key == "map_Kd":
                cur.map_kd = tok[1]
    return materials
