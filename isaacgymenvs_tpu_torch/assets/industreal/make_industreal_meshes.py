"""Writes the four mesh stand-ins of the IndustReal tasks (PegsInsert with
the 8 mm round peg, GearsInsert with the medium gear) into mesh/:

  * industreal_pegs/industreal_round_peg_8mm.obj stands in for the
    reference's plug: a closed cylinder of the asset yaml's plug diameter
    7.986 mm, its base at z = 3 mm (PLUG_BASE_Z) and its top at 53 mm (a
    length of 50 mm), axis +z;
  * industreal_pegs/industreal_tray_insert_round_peg_8mm.obj stands in for
    the reference's socket: a cylinder of radius 28.3 mm (the radius the
    task's inertials take) and 28 mm tall (SOCKET_HEIGHT), base at z = 0,
    with a blind round hole of 8.5 mm diameter (0.514 mm of diametral
    clearance around the peg) from its top down to z = 3 mm, so that a peg
    whose origin coincides with the socket's sits on the hole's floor: the
    two OBJ files share one assembled frame, as the reference's do;
  * industreal_gears/industreal_gear_base.obj stands in for the gear base:
    a plate 150 mm (x from -75 to +75 mm) by 50 mm, 5 mm tall (BASE_HEIGHT),
    and three shafts of 9.5 mm diameter (16-gons, their corners on the
    circle) at x = -30, +20 and +50 mm, from the plate's top up 20 mm
    (SHAFT_HEIGHT) to z = 25 mm;
  * industreal_gears/industreal_gear_medium.obj stands in for the medium
    gear: an annulus about x = +20 mm (GEAR_CENTER) from z = 5 mm
    (GEAR_BOTTOM_Z) to 25 mm (GEAR_HEIGHT), with a round bore of 10 mm
    diameter (0.25 mm of radial fit at the shaft's corners, 0.34 mm at its
    flats) and 22 trapezoid teeth, their tips at 21 mm (GEAR_OUTER_R) and
    their roots at 19.5 mm. Assembled, it sits on the plate over the
    middle shaft.

The choices that the JAX task files leave open, and why:
  * every ring is sampled at angles offset by half a segment (the peg's in
    32 segments, the socket's in 64, the gear's in 88), so that no vertex
    lies on a bin edge of the tasks' stratified picks (12, 8 and 16 angle
    bins of the peg, 10 and 12 of the gear): each bin holds the same number
    of vertices of every ring, and both packages' picks are the same;
  * the peg has four rings below PLUG_BASE_Z + 6 mm (its tip set: z = 3,
    5.5, 7.5 and 8.5 mm, each of the 3 height bins of `plug_contact_points`
    holding one or two) and five above (12.5, 21.5, 30.5, 39.5 and 53 mm,
    one per height bin of the shaft set): 36 tip points and 40 shaft
    points, 76 in all, and 112 sample points (7 of the 16 height bins of
    `plug_sample_points` hold a ring, x 16 angle bins);
  * the socket's hole has a 1 mm chamfer at 45 degrees at its mouth (its
    radius 5.25 mm at the top face, 4.25 mm from 1 mm below): a peg a
    little off the axis rides it into the hole;
  * the gear's bore is sampled in five rings (z = 5, 10, 15, 20 and 25 mm),
    one in each height bin of `gear_contact_points`' bore set (the
    vertices within 1.5 mm of the bore's radius): its 5 x 10 pick fills
    all 50 bins; the bottom face holds rings at 7.5, 10 and 12.5 mm from
    the axis, so that the hub set (below z = 7 mm, within 13 mm of the
    axis) picks one point per 30-degree bin on the ring at 10 mm (the
    middle of the bin's vertices in file order: bore ring, 7.5, 10, 12.5),
    and the rim set (below 7 mm, beyond 18 mm) one per bin on the teeth's
    bottom edge (at a tip or a root): 12 hub and 12 rim points;
  * the teeth are placed so that a root lies centred on +y and on -y (22
    teeth of 16.36 degrees, each 4 segments: 2 at the tip, 2 at the root):
    the reset closes the fingers across the gear along y, and the pads'
    points 3 mm either side of the finger's midline then press on the
    middles of two tips that lie mirrored about it, so that their forces
    hold the gear without turning it. With the teeth at another phase
    those points pressed on flanks of one hand and spun the 19 g gear to
    25 rad/s in one step;
  * the base is a closed plate and three closed shafts that stand on its
    top face, not one merged surface: the voxelizer takes its sign from
    the parity of +x ray crossings, which the shafts' and the plate's walls
    give right on either side of z = 5 mm. The plate's top face under each
    shaft and the shaft's bottom face are then faces inside the solid: the
    grid's depth there, within the shaft's foot, is the distance to z = 5
    mm rather than to the shaft's wall. No contact point reaches into a
    shaft's foot.

Every mesh is watertight and wound outward. Run from anywhere:
`python isaacgymenvs_tpu_torch/assets/industreal/make_industreal_meshes.py`.
The output is deterministic; the committed files are its output.
"""
from __future__ import annotations

import os

import numpy as np

# industreal_asset_info_pegs.yaml round_peg_hole_8mm (isaacgymenvs_tpu/tasks/industreal_pegs_insert.py:61-68)
PLUG_DIAMETER = 0.007986
PLUG_LENGTH = 0.050
PLUG_BASE_Z = 0.003
SOCKET_HEIGHT = 0.028
SOCKET_RADIUS = 0.0283
HOLE_RADIUS = 0.00425
CHAMFER = 0.001

# industreal_asset_info_gears.yaml (isaacgymenvs_tpu/tasks/industreal_gears_insert.py:71-79)
BASE_HEIGHT = 0.005
SHAFT_HEIGHT = 0.020
GEAR_BOTTOM_Z = 0.005
GEAR_HEIGHT = 0.025
GEAR_CENTER_X = 0.02
GEAR_OUTER_R = 0.021
GEAR_ROOT_R = 0.0195
GEAR_TEETH = 22
BORE_RADIUS = 0.005
SHAFT_RADIUS = 0.00475
SHAFT_X = (-0.03, 0.02, 0.05)
PLATE_HALF = (0.075, 0.025)

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "mesh")


def _angles(segments: int) -> np.ndarray:
    return 2 * np.pi * (np.arange(segments) + 0.5) / segments


def _ring(verts: list, r, z: float, ang: np.ndarray, cx: float = 0.0) -> int:
    """Append a ring of vertices; returns its first index. `r` is a radius
    or one radius per angle."""
    start = len(verts)
    r = np.broadcast_to(np.asarray(r, np.float64), ang.shape)
    verts += [(cx + rr * np.cos(t), rr * np.sin(t), z) for t, rr in zip(ang, r)]
    return start


def _band(faces: list, lo: int, hi: int, segments: int, outward: bool = True):
    """Quads between two rings of `segments` vertices (lo below hi): facing
    away from the axis when `outward`, towards it otherwise."""
    for k in range(segments):
        a, b = lo + k, lo + (k + 1) % segments
        c, d = hi + (k + 1) % segments, hi + k
        faces.append((a, b, c, d) if outward else (a, d, c, b))


def _annulus(faces: list, inner: int, outer: int, segments: int, up: bool):
    """Quads between an inner and an outer ring at one height: facing +z
    when `up`."""
    for k in range(segments):
        a, b = inner + k, inner + (k + 1) % segments
        c, d = outer + (k + 1) % segments, outer + k
        faces.append((a, d, c, b) if up else (a, b, c, d))


def peg(segments: int = 32):
    ang, r = _angles(segments), PLUG_DIAMETER / 2
    verts, faces = [], []
    zs = [PLUG_BASE_Z, 0.0055, 0.0075, 0.0085, 0.0125, 0.0215, 0.0305, 0.0395, PLUG_BASE_Z + PLUG_LENGTH]
    rings = [_ring(verts, r, z, ang) for z in zs]
    for lo, hi in zip(rings, rings[1:]):
        _band(faces, lo, hi, segments)
    faces.append(tuple(rings[-1] + k for k in range(segments)))  # top cap, +z
    faces.append(tuple(rings[0] + k for k in reversed(range(segments))))  # bottom cap, -z
    return np.asarray(verts), faces


def socket(segments: int = 64):
    ang = _angles(segments)
    verts, faces = [], []
    ob = _ring(verts, SOCKET_RADIUS, 0.0, ang)
    ot = _ring(verts, SOCKET_RADIUS, SOCKET_HEIGHT, ang)
    mouth = _ring(verts, HOLE_RADIUS + CHAMFER, SOCKET_HEIGHT, ang)
    wall_top = _ring(verts, HOLE_RADIUS, SOCKET_HEIGHT - CHAMFER, ang)
    floor = _ring(verts, HOLE_RADIUS, PLUG_BASE_Z, ang)
    _band(faces, ob, ot, segments)  # outer wall
    _annulus(faces, mouth, ot, segments, up=True)  # top face
    _band(faces, wall_top, mouth, segments, outward=False)  # chamfer, facing the axis
    _band(faces, floor, wall_top, segments, outward=False)  # hole wall
    faces.append(tuple(floor + k for k in range(segments)))  # hole floor, +z
    faces.append(tuple(ob + k for k in reversed(range(segments))))  # bottom, -z
    return np.asarray(verts), faces


def gear_base(shaft_segments: int = 16):
    (hx, hy), h = PLATE_HALF, BASE_HEIGHT
    verts = [(x, y, z) for z in (0.0, h) for y in (-hy, hy) for x in (-hx, hx)]
    faces = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
    ang = 2 * np.pi * np.arange(shaft_segments) / shaft_segments
    for x in SHAFT_X:
        lo = _ring(verts, SHAFT_RADIUS, h, ang, cx=x)
        hi = _ring(verts, SHAFT_RADIUS, h + SHAFT_HEIGHT, ang, cx=x)
        _band(faces, lo, hi, shaft_segments)
        faces.append(tuple(hi + k for k in range(shaft_segments)))  # the shaft's top, +z
        faces.append(tuple(lo + k for k in reversed(range(shaft_segments))))  # its foot, -z
    return np.asarray(verts), faces


def gear_medium(segments: int = 88):
    ang = _angles(segments)
    tooth = segments // GEAR_TEETH
    r_out = np.where(np.isin(np.arange(segments) % tooth, (1, 2)), GEAR_ROOT_R, GEAR_OUTER_R)
    verts, faces = [], []
    cx = GEAR_CENTER_X
    bore = [_ring(verts, BORE_RADIUS, z, ang, cx) for z in np.linspace(GEAR_BOTTOM_Z, GEAR_HEIGHT, 5)]
    hub = [_ring(verts, r, GEAR_BOTTOM_Z, ang, cx) for r in (0.0075, 0.0100, 0.0125)]
    ob = _ring(verts, r_out, GEAR_BOTTOM_Z, ang, cx)
    ot = _ring(verts, r_out, GEAR_HEIGHT, ang, cx)
    for lo, hi in zip(bore, bore[1:]):
        _band(faces, lo, hi, segments, outward=False)  # the bore, facing the axis
    for inner, outer in zip([bore[0], *hub], [*hub, ob]):
        _annulus(faces, inner, outer, segments, up=False)  # the bottom face, -z
    _annulus(faces, bore[-1], ot, segments, up=True)  # the top face, +z
    _band(faces, ob, ot, segments)  # the teeth
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
        f.write(f"# {header}\n# written by assets/industreal/make_industreal_meshes.py\n")
        for v in verts:
            f.write("v {:.9f} {:.9f} {:.9f}\n".format(*v))
        for fc in faces:
            f.write("f " + " ".join(str(i + 1) for i in fc) + "\n")


def main():
    pegs, gears = os.path.join(OUT, "industreal_pegs"), os.path.join(OUT, "industreal_gears")
    os.makedirs(pegs, exist_ok=True)
    os.makedirs(gears, exist_ok=True)
    v, f = peg()
    cyl = np.pi * (PLUG_DIAMETER / 2) ** 2 * PLUG_LENGTH
    assert abs(signed_volume(v, f) - cyl) < 0.02 * cyl
    write_obj(os.path.join(pegs, "industreal_round_peg_8mm.obj"), v, f,
              "round peg, 8 mm: cylinder d 7.986 mm x 50 mm, base at z = 3 mm, axis +z")
    v, f = socket()
    full = np.pi * SOCKET_RADIUS ** 2 * SOCKET_HEIGHT
    assert 0.9 * full < signed_volume(v, f) < full
    write_obj(os.path.join(pegs, "industreal_tray_insert_round_peg_8mm.obj"), v, f,
              "tray insert, 8 mm round peg: cylinder r 28.3 mm x 28 mm, hole d 8.5 mm down to z = 3 mm")
    v, f = gear_base()
    plate = 4 * PLATE_HALF[0] * PLATE_HALF[1] * BASE_HEIGHT
    assert plate < signed_volume(v, f) < plate + 3 * np.pi * SHAFT_RADIUS ** 2 * SHAFT_HEIGHT
    write_obj(os.path.join(gears, "industreal_gear_base.obj"), v, f,
              "gear base: plate 150 x 50 x 5 mm, shafts d 9.5 mm x 20 mm at x = -30, 20, 50 mm")
    v, f = gear_medium()
    ring = np.pi * (GEAR_OUTER_R ** 2 - BORE_RADIUS ** 2) * (GEAR_HEIGHT - GEAR_BOTTOM_Z)
    assert 0.8 * ring < signed_volume(v, f) < ring
    write_obj(os.path.join(gears, "industreal_gear_medium.obj"), v, f,
              "medium gear: 22 teeth r 19.5-21 mm, bore d 10 mm, z 5-25 mm, axis at x = 20 mm")


if __name__ == "__main__":
    main()
