"""Writes the mesh of the cabinet stand-in's drawer handles,
meshes/drawer_handle.obj: a straight bar 0.2 m long along its y axis, an
octagonal prism of circumradius 10 mm (a vertex on each of the x and z
axes, so that its bounding box is 20 mm x 200 mm x 20 mm), centred on the
origin; closed and wound outward.

A URDF parser reads it as a MESH geom with half-extents (0.01, 0.1, 0.01)
and 4 farthest-point vertices as contact candidates; a pair row against a
MESH geom takes the cylinder branch of the physics step, a cylinder of
radius 0.01 (the x half-extent) and half-height 0.1 (the y half-extent)
about the geom's z axis, so urdf/sektion_cabinet_2.urdf turns the handle's
collision frame to lay that cylinder along the drawer front.

Run from anywhere: `python isaacgymenvs_tpu_torch/assets/urdf/sektion_cabinet_model/make_cabinet_meshes.py`.
The output is deterministic; the committed file is its output.
"""
from __future__ import annotations

import os

import numpy as np

RADIUS = 0.01
HALF_LENGTH = 0.1
SEGMENTS = 8

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "meshes", "drawer_handle.obj")


def handle_bar():
    """(vertices (16, 3), triangles (28, 3), 0-based) of the bar."""
    ang = 2 * np.pi * np.arange(SEGMENTS) / SEGMENTS
    ring = np.stack([RADIUS * np.cos(ang), RADIUS * np.sin(ang)], -1)  # (x, z) around y
    verts = np.array([[x, y, z] for y in (-HALF_LENGTH, HALF_LENGTH) for x, z in ring])
    tris = []
    for k in range(SEGMENTS):
        a, b = k, (k + 1) % SEGMENTS
        # side quad between the two rings, outward
        tris += [(a, SEGMENTS + a, SEGMENTS + b), (a, SEGMENTS + b, b)]
    for k in range(1, SEGMENTS - 1):  # end caps as fans
        tris.append((0, k + 1, k))
        tris.append((SEGMENTS, SEGMENTS + k, SEGMENTS + k + 1))
    return verts, np.asarray(tris)


def write_obj(path, verts, tris):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("# drawer handle bar of the sektion cabinet stand-in (make_cabinet_meshes.py)\n")
        for v in verts:
            f.write("v {:.6f} {:.6f} {:.6f}\n".format(*v))
        for t in tris:
            f.write("f {} {} {}\n".format(*(t + 1)))


if __name__ == "__main__":
    write_obj(OUT, *handle_bar())
    print(OUT)
