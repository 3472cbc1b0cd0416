"""Writes the two mesh stand-ins of the Factory nut-bolt tasks (M16, tight
fit) into mesh/factory_nut_bolt/:

  * factory_nut_m16_tight_subdiv_3x.obj stands in for the reference's nut:
    a hexagonal prism 24 mm across the flats and 27.71281 mm across the
    corners (the asset yaml's nut widths), 13 mm tall, base at z = 0, with
    a threaded bore along z;
  * factory_bolt_m16_tight.obj stands in for the reference's bolt: a
    hexagonal head 30 mm across the flats and 16 mm tall (the yaml's head
    height) on z = 0 to 0.016, and a threaded shank of 16 mm major diameter
    (the yaml's bolt width) on z = 0.016 to 0.041 (the yaml's shank length
    of 25 mm), its top end flat.

Both threads are one right-handed helix of the yaml's 2 mm pitch: the
surface's radius at angle theta and height z is a function of the phase
phi = frac((z - pitch * theta / 2 pi) / pitch + c), so that turning by
d theta and rising by pitch * d theta / 2 pi leaves the surface unchanged,
and a nut turned clockwise (seen from above) runs down the bolt. The bolt's
profile is the ISO 60-degree trapezoid: over one pitch a root flat of
pitch / 4 at radius 8 mm - 5/8 H (H = 0.866 pitch: a thread depth of
1.0825 mm), a flank rising over 0.625 mm, a crest flat of pitch / 8 at
8 mm and a flank falling over 0.625 mm (the flank that faces up). The nut's
bore is the same profile widened by a radial clearance of 0.1 mm (0.05 mm
normal to the flanks): crest 7.0175 mm, root 8.1 mm from the axis.

The choices that the JAX task file leaves open, and why:
  * the nut's corners lie at 30, 90, ..., 330 degrees, so that its flats
    face +-x: the task yaws a gripped nut by pi/2 from the hand
    (NUT_GRIP_YAW) to put the flats against the finger pads; each corner
    is a vertex and lies in the middle of one of the six 60-degree bins of
    `nut_contact_points`, at both faces (its 12 rim points);
  * the nut's phase constant puts it in mesh with the bolt, its thread
    centred in the bolt's groove, when its base stands at z = 0.0405 with a
    yaw of 30 degrees: the Screw task's reset pose (BOLT_TOP - 0.5 mm,
    nut_rot_initial 30). Any other pose on the helix through it is in mesh
    too; the free nut of the JAX package's slow test (z = 0.037 at 30
    degrees) starts a quarter pitch off it and drops into the groove;
  * the bore is sampled in rings every 0.125 mm of height (105 rings) and
    every 7.5 degrees, written ring by ring before the hex's vertices: all
    its vertices lie between 7.0175 and 8.1 mm from the axis (the thread
    band of `nut_contact_points`, 6.5 to 8.5 mm), and its 6 x 8 stratified
    pick fills all 48 bins (48 thread points). The pick takes the middle
    vertex of each bin in file order: the rings go bottom to top, except
    that the ring 0.25 mm above the base is written in the middle of the
    lowest bin's 18 rings, so that the lowest 8 thread points lie 0.25 mm
    above the base (the other 40 near the middle height of their bins).
    At the Screw reset, whose base is 0.5 mm below the bolt's top, those 8
    are already in the groove and carry the nut along the helix from the
    first turn; with a pick at mid-bin (1.1 mm up) the nut turned above the
    bolt's end out of mesh, and the JAX package's press-and-rotate test
    (tests/test_factory_nut_bolt.py:127) saw it slide 1.5 mm down unturned;
  * the bolt's head is a hexagon 30 mm across the flats (more than the
    nut's 27.7 mm across the corners, so that a nut screwed fully down
    seats on it at every yaw), corners at 30 + 60 k degrees; the shank is
    sampled every 0.125 mm and 7.5 degrees as the bore is.

Both meshes are watertight and wound outward, since the voxelizer takes its
sign from scanline parity. Run from anywhere:
`python isaacgymenvs_tpu_torch/assets/factory/make_nut_bolt_meshes.py`.
The output is deterministic; the committed files are its output.
"""
from __future__ import annotations

import os

import numpy as np

# factory_asset_info_nut_bolt.yaml nut_bolt_m16_tight
NUT_WIDTH_MIN = 0.024
NUT_WIDTH_MAX = 0.02771281
NUT_HEIGHT = 0.013
BOLT_WIDTH = 0.016
BOLT_HEAD_HEIGHT = 0.016
BOLT_SHANK_LENGTH = 0.025
THREAD_PITCH = 0.002

HEAD_WIDTH = 0.030  # across the flats
THREAD_DEPTH = 5.0 / 8.0 * np.sqrt(3.0) / 2.0 * THREAD_PITCH
CLEARANCE = 1e-4  # radial, nut bore over bolt
SEGMENTS = 48  # around the axis: 7.5 degrees, the hex corners among them
DZ = 1.25e-4  # ring spacing along the axis
LOW_RING = 2  # the nut's lowest thread points: 0.25 mm above its base
NUT_PHASE = ((0.0405 - THREAD_PITCH / 12.0) / THREAD_PITCH) % 1.0  # in mesh at z 0.0405, yaw 30 degrees

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mesh", "factory_nut_bolt")


def bolt_profile(phase: np.ndarray) -> np.ndarray:
    """Radius of the bolt's thread at a phase in [0, 1): root flat, the
    rising flank, crest flat, the falling (upward-facing) flank."""
    r_crest = BOLT_WIDTH / 2
    r_root = r_crest - THREAD_DEPTH
    return np.interp(phase, [0.0, 0.25, 0.5625, 0.6875, 1.0], [r_root, r_root, r_crest, r_crest, r_root])


def thread_radius(theta, z, const, clearance=0.0):
    phase = ((z - THREAD_PITCH * theta / (2 * np.pi)) / THREAD_PITCH + const) % 1.0
    return bolt_profile(phase) + clearance


def hex_radius(theta, across_flats):
    """Radius of a hexagon with corners at 30 + 60 k degrees (flats facing +-x)."""
    rel = (theta + np.pi / 6) % (np.pi / 3) - np.pi / 6
    return across_flats / 2 / np.cos(rel)


def _angles():
    return 2 * np.pi * np.arange(SEGMENTS) / SEGMENTS


def _rings(z_lo, z_hi):
    n = int(round((z_hi - z_lo) / DZ))
    return z_lo + (z_hi - z_lo) * np.arange(n + 1) / n


def nut():
    ang, zs = _angles(), _rings(0.0, NUT_HEIGHT)
    a = SEGMENTS
    # the bore's rings first (the thread band of the pick), bottom to top,
    # but for the ring at z = 0.25 mm, written in the middle of the rings of
    # the lowest height bin of the pick, which takes that bin's middle vertices
    low_bin = int(np.sum(zs < NUT_HEIGHT / 6))
    order = list(range(len(zs)))
    order.remove(LOW_RING)
    order.insert(low_bin // 2, LOW_RING)
    slot = {k: i for i, k in enumerate(order)}
    verts = [(r * np.cos(t), r * np.sin(t), zs[k]) for k in order
             for t, r in zip(ang, thread_radius(ang, zs[k], NUT_PHASE, CLEARANCE))]
    nb = len(verts)
    rh = hex_radius(ang, NUT_WIDTH_MIN)
    for z in (0.0, NUT_HEIGHT):
        verts += [(r * np.cos(t), r * np.sin(t), z) for t, r in zip(ang, rh)]
    bore = lambda k, j: slot[k] * a + j % a
    hb = lambda j: nb + j % a
    ht = lambda j: nb + a + j % a
    top = len(zs) - 1
    faces = []
    for k in range(top):
        for j in range(a):  # the bore wall, facing the axis
            faces.append((bore(k, j), bore(k + 1, j), bore(k + 1, j + 1), bore(k, j + 1)))
    for j in range(a):
        faces.append((hb(j), hb(j + 1), ht(j + 1), ht(j)))  # hex walls
        faces.append((bore(top, j), ht(j), ht(j + 1), bore(top, j + 1)))  # top face, +z
        faces.append((bore(0, j), bore(0, j + 1), hb(j + 1), hb(j)))  # bottom face, -z
    return np.asarray(verts), faces


def bolt():
    ang, zs = _angles(), _rings(BOLT_HEAD_HEIGHT, BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH)
    a = SEGMENTS
    verts = [(r * np.cos(t), r * np.sin(t), z) for z in zs for t, r in zip(ang, thread_radius(ang, z, 0.0))]
    ns = len(verts)
    rh = hex_radius(ang, HEAD_WIDTH)
    for z in (0.0, BOLT_HEAD_HEIGHT):
        verts += [(r * np.cos(t), r * np.sin(t), z) for t, r in zip(ang, rh)]
    verts += [(0.0, 0.0, 0.0), (0.0, 0.0, zs[-1])]  # the centres of the bottom face and of the end face
    shank = lambda k, j: k * a + j % a
    hb = lambda j: ns + j % a
    ht = lambda j: ns + a + j % a
    c_bot, c_top = ns + 2 * a, ns + 2 * a + 1
    top = len(zs) - 1
    faces = []
    for k in range(top):
        for j in range(a):  # the threaded shank, facing out
            faces.append((shank(k, j), shank(k, j + 1), shank(k + 1, j + 1), shank(k + 1, j)))
    for j in range(a):
        faces.append((hb(j), hb(j + 1), ht(j + 1), ht(j)))  # head walls
        faces.append((ht(j), ht(j + 1), shank(0, j + 1), shank(0, j)))  # head top, +z
        faces.append((c_bot, hb(j + 1), hb(j)))  # head bottom, -z
        faces.append((c_top, shank(top, j), shank(top, j + 1)))  # end face, +z
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
        f.write(f"# {header}\n# written by assets/factory/make_nut_bolt_meshes.py\n")
        for v in verts:
            f.write("v {:.9f} {:.9f} {:.9f}\n".format(*v))
        for fc in faces:
            f.write("f " + " ".join(str(i + 1) for i in fc) + "\n")


def main():
    os.makedirs(OUT, exist_ok=True)
    mean_r2 = lambda clearance: float(np.mean((bolt_profile(np.linspace(0, 1, 4000, endpoint=False)) + clearance) ** 2))
    v, f = nut()
    vol = signed_volume(v, f)
    assert abs(vol - (np.sqrt(3) / 2 * NUT_WIDTH_MIN ** 2 - np.pi * mean_r2(CLEARANCE)) * NUT_HEIGHT) < 0.02 * vol
    write_obj(os.path.join(OUT, "factory_nut_m16_tight_subdiv_3x.obj"), v, f,
              "M16 nut, tight: hex 24 mm across flats x 13 mm, right-handed 2 mm thread bore, base at z = 0")
    v, f = bolt()
    vol = signed_volume(v, f)
    shank = np.pi * mean_r2(0.0) * BOLT_SHANK_LENGTH
    assert abs(vol - (np.sqrt(3) / 2 * HEAD_WIDTH ** 2 * BOLT_HEAD_HEIGHT + shank)) < 0.02 * vol
    write_obj(os.path.join(OUT, "factory_bolt_m16_tight.obj"), v, f,
              "M16 bolt, tight: hex head 30 mm across flats x 16 mm, 25 mm shank with a right-handed 2 mm thread")


if __name__ == "__main__":
    main()
