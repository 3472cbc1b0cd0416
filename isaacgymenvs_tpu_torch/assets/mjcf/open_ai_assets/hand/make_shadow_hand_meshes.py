"""Writes the STL meshes of the ShadowHand stand-in (shadow_hand.xml beside
this file) into ../stls/hand/, as binary STL in metres:

  * forearm.stl: a tapered block, the forearm from the mount (y = 0) to the
    wrist (y = -0.29): 0.09 m wide and 0.05 m thick at the mount, 0.06 by
    0.035 at the wrist;
  * palm.stl: a slab 0.066 m wide (x) and 0.095 m long (y, from the wrist
    joint toward the fingers), its top face, which holds the object, at
    z = +0.011 and its back at z = -0.012, the back's edges set in by 4 mm;
  * lfmetacarpal.stl: the little finger's metacarpal inside the palm's
    edge, a block 0.016 m wide, 0.075 long, from z = -0.012 to +0.004: at
    the top of its joint's range (0.785 rad) it stays below the palm's top
    face, so that cupping the palm does not lift the object.

Each is a convex hexahedron (two rectangles joined by four faces), 8
vertices and 12 triangles, so that the MJCF parsers' farthest-point picks
(6 candidates per mesh) and axis-aligned boxes are exact functions of the
sizes above. The XML scales none of them. Deterministic; run it from
anywhere:

    python isaacgymenvs_tpu_torch/assets/mjcf/open_ai_assets/hand/make_shadow_hand_meshes.py
"""
from __future__ import annotations

import os
import struct

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "stls", "hand")


def hexahedron(bottom, top):
    """Vertices (8, 3) and triangles (12, 3) of the hull of two rectangles:
    `bottom` and `top` are (x0, x1, y0, y1, z) each."""
    def rect(r):
        x0, x1, y0, y1, z = r
        return [(x0, y0, z), (x1, y0, z), (x1, y1, z), (x0, y1, z)]

    v = np.asarray(rect(bottom) + rect(top), np.float64)
    tri = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7)]  # bottom (down), top (up)
    for i in range(4):
        j = (i + 1) % 4
        tri += [(i, j, 4 + j), (i, 4 + j, 4 + i)]
    return v, np.asarray(tri)


def write_stl(path: str, v: np.ndarray, tri: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"shadow hand stand-in".ljust(80, b" "))
        f.write(struct.pack("<I", len(tri)))
        for a, b, c in tri:
            n = np.cross(v[b] - v[a], v[c] - v[a])
            n = n / np.linalg.norm(n)
            f.write(struct.pack("<12fH", *n, *v[a], *v[b], *v[c], 0))


MESHES = {
    "forearm": ((-0.045, 0.045, 0.0, -0.29, -0.03), (-0.03, 0.03, 0.0, -0.29, 0.02)),
    "palm": ((-0.029, 0.029, -0.004, -0.091, -0.012), (-0.033, 0.033, 0.0, -0.095, 0.011)),
    "lfmetacarpal": ((-0.008, 0.008, 0.0, -0.075, -0.012), (-0.008, 0.008, 0.0, -0.075, 0.004)),
}


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    for name, (bottom, top) in MESHES.items():
        write_stl(os.path.join(OUT, f"{name}.stl"), *hexahedron(bottom, top))


if __name__ == "__main__":
    main()
