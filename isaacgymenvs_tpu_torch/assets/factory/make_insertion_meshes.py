"""Writes the two mesh stand-ins of FactoryTaskInsertion (round peg, 16 mm
tight fit) into mesh/factory_insertion/:

  * factory_round_peg_16mm_tight.obj stands in for the reference's plug
    mesh of the same name: a closed cylinder of the asset yaml's
    plug diameter 15.994 mm and length 50 mm, base at z = 0, axis +z;
    16 segments around it and 8 rings along z: the two end rings and six
    at the middles of the inner height bins of the task's stratified pick
    (8 height bins x 8 angle bins), so that the pick finds a vertex in every
    bin, each bin's vertices on one ring, and the bottom ring is picked
    (64 contact points, 8 of them on the base);
  * factory_round_hole_16mm_subdiv_3x.obj stands in for the reference's
    socket mesh: a 40 mm square block, the asset yaml's socket height of
    8.9916 mm tall, base at z = 0, with a 16 mm round bore through it along
    z (a 48-gon whose flats lie 8 mm from the axis). It is watertight and
    wound outward, since the voxelizer takes its sign from scanline parity.

Run from anywhere: `python isaacgymenvs_tpu_torch/assets/factory/make_insertion_meshes.py`.
The output is deterministic; the committed files are its output.
"""
from __future__ import annotations

import os

import numpy as np

PEG_DIAMETER = 0.015994  # factory_asset_info_insertion.yaml round_peg_hole_16mm_tight
PEG_LENGTH = 0.050
HOLE_HEIGHT = 0.0089916
BORE_DIAMETER = 0.016
BLOCK_HALF_WIDTH = 0.020

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mesh", "factory_insertion")


def peg(segments: int = 16):
    r, length = PEG_DIAMETER / 2, PEG_LENGTH
    ang = 2 * np.pi * (np.arange(segments) + 0.5) / segments
    heights = [0.0] + [length * (i + 0.5) / 8 for i in range(1, 7)] + [length]
    rings = len(heights)
    verts = [(r * np.cos(a), r * np.sin(a), z) for z in heights for a in ang]
    vid = lambda i, k: i * segments + k % segments
    faces = [(vid(i, k), vid(i, k + 1), vid(i + 1, k + 1), vid(i + 1, k))
             for i in range(rings - 1) for k in range(segments)]
    faces.append(tuple(vid(rings - 1, k) for k in range(segments)))  # top cap, +z
    faces.append(tuple(vid(0, k) for k in reversed(range(segments))))  # bottom cap, -z
    return np.asarray(verts), faces


def hole(segments: int = 48):
    w, hgt = BLOCK_HALF_WIDTH, HOLE_HEIGHT
    ang = 2 * np.pi * np.arange(segments) / segments  # includes the square's corners
    r_v = BORE_DIAMETER / 2 / np.cos(np.pi / segments)  # flats at the bore radius
    c, s = np.cos(ang), np.sin(ang)
    inner = np.stack([r_v * c, r_v * s], 1)
    outer = np.stack([c, s], 1) * (w / np.maximum(np.abs(c), np.abs(s)))[:, None]
    verts = []
    for z in (0.0, hgt):  # ib, ob (bottom), it, ot (top)
        verts += [(x, y, z) for x, y in inner] + [(x, y, z) for x, y in outer]
    ib = lambda k: k % segments
    ob = lambda k: segments + k % segments
    it = lambda k: 2 * segments + k % segments
    ot = lambda k: 3 * segments + k % segments
    faces = []
    for k in range(segments):
        faces.append((it(k), ot(k), ot(k + 1), it(k + 1)))  # top, +z
        faces.append((ib(k), ib(k + 1), ob(k + 1), ob(k)))  # bottom, -z
        faces.append((ob(k), ob(k + 1), ot(k + 1), ot(k)))  # outer walls
        faces.append((ib(k), it(k), it(k + 1), ib(k + 1)))  # bore wall, facing the axis
    return np.asarray(verts), faces


def signed_volume(verts, faces) -> float:
    vol = 0.0
    for f in faces:
        for k in range(1, len(f) - 1):
            a, b, c = verts[f[0]], verts[f[k]], verts[f[k + 1]]
            vol += np.dot(a, np.cross(b, c)) / 6.0
    return vol


def write_obj(path, verts, faces, header):
    with open(path, "w") as f:
        f.write(f"# {header}\n# written by assets/factory/make_insertion_meshes.py\n")
        for v in verts:
            f.write("v {:.9f} {:.9f} {:.9f}\n".format(*v))
        for fc in faces:
            f.write("f " + " ".join(str(i + 1) for i in fc) + "\n")


def main():
    os.makedirs(OUT, exist_ok=True)
    v, f = peg()
    assert signed_volume(v, f) > 0
    write_obj(os.path.join(OUT, "factory_round_peg_16mm_tight.obj"), v, f,
              "round peg, 16 mm tight: cylinder d 15.994 mm x 50 mm, base at z = 0")
    v, f = hole()
    block = (2 * BLOCK_HALF_WIDTH) ** 2 * HOLE_HEIGHT
    assert 0 < signed_volume(v, f) < block
    write_obj(os.path.join(OUT, "factory_round_hole_16mm_subdiv_3x.obj"), v, f,
              "round hole, 16 mm: 40 mm square block 8.9916 mm tall with a 16 mm bore, base at z = 0")


if __name__ == "__main__":
    main()
