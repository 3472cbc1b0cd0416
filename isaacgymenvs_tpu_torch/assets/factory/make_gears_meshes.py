"""Writes the four mesh stand-ins of FactoryTaskGears into mesh/ and
../industreal/mesh/:

  * factory_gears/factory_gear_small_space_5e-4.obj: the small gear, 20
    teeth, tips at 11 mm from its axis (roots at 10 mm), the axis at
    x = 50.5 mm, so that the gear spans x from 39.5 to 61.5 mm;
  * factory_gears/factory_gear_medium_space_5e-4.obj: the medium gear, 40
    teeth, tips at 21 mm (roots at 20 mm), the axis at x = 20.2 mm;
  * ../industreal/mesh/industreal_gears/industreal_gear_large.obj: the large
    gear, 60 teeth, tips at 31 mm (roots at 30 mm), the axis at
    x = -30.2 mm. The reference's asset tree has no
    factory_gear_large_space_5e-4.obj, and the task takes IndustReal's large
    gear in its place, in the same assembled frame;
  * factory_gears/factory_gear_base_tight_space_5e-4_subdiv_4x.obj: the
    base, a plate 150 mm (x from -75 to 75 mm) by 50 mm, 5 mm tall, and
    three shafts of 8 mm diameter standing on it up to z = 25 mm, one under
    each gear's axis (x = 50.5, 20.2 and -30.2 mm). The file name is the
    reference's; the stand-in is not subdivided.

The heights are those of the public Factory asset yaml
(factory_asset_info_gears.yaml): the base's height 5 mm, the gears' 25 mm
(a gear spans z from the plate's top at 5 mm to 25 mm), the shafts' 20 mm.
The radii and axes are the ones isaacgymenvs_tpu/tasks/factory_templates.py
gives each gear's mass and centre of mass (0.011 / 0.021 / 0.031 m about
x = 0.0508 / 0.0202 / -0.0302). Every gear has a round bore of 9 mm
diameter, 0.5 mm of radial play about its shaft (the `space_5e-4` of the
names): assembled, each gear sits on the plate over its shaft.

The choices that the task file leaves open, and why:
  * a gear is two rings of vertices per height, its bore's ring first and
    then its teeth's, at z = 5, 7.5, 12.5, 17.5, 22.5 and 25 mm: the ends
    and the middles of the 4 height bins of `gear_template_points` (the
    3rd and 4th bin hold two heights each), so that no vertex lies near a
    bin edge;
  * every ring has 4 segments per tooth (2 at the tip, 2 at the root) and
    is sampled at angles offset by half a segment, so that no vertex lies
    on an edge of the pick's 10 angle bins about the gear's centroid, and
    the rings are regular, so that the centroid is the axis. Each bin then
    holds a whole number of teeth of every ring, and its middle vertex in
    file order is the first teeth vertex of its lowest height, which is a
    tip: each gear's 40 contact points lie on its tips at z = 5, 12.5,
    17.5 and 22.5 mm, 10 of them on its bottom face's rim, on which the
    gear rests on the table;
  * the base is a closed plate and three closed shafts that stand on its
    top face, not one merged surface, as in make_industreal_meshes.py: the
    voxelizer takes its sign from the parity of +x ray crossings.

Every mesh is watertight and wound outward. Run from anywhere:
`python isaacgymenvs_tpu_torch/assets/factory/make_gears_meshes.py`.
The output is deterministic; the committed files are its output.
"""
from __future__ import annotations

import os

import numpy as np

# factory_asset_info_gears.yaml: base.height, gears.height, shafts.height
BASE_HEIGHT = 0.005
GEAR_TOP_Z = 0.025
SHAFT_HEIGHT = 0.020
# gear -> (teeth, tip radius, axis x); roots lie 1 mm inside the tips
GEARS = {"small": (20, 0.011, 0.0505), "medium": (40, 0.021, 0.0202), "large": (60, 0.031, -0.0302)}
ROOT_DEPTH = 0.001
SHAFT_RADIUS = 0.004
BORE_RADIUS = SHAFT_RADIUS + 0.0005
PLATE_HALF = (0.075, 0.025)
RING_Z = (BASE_HEIGHT, 0.0075, 0.0125, 0.0175, 0.0225, GEAR_TOP_Z)

HERE = os.path.dirname(os.path.abspath(__file__))
FACTORY = os.path.join(HERE, "mesh", "factory_gears")
INDUSTREAL = os.path.join(os.path.dirname(HERE), "industreal", "mesh", "industreal_gears")


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


def gear(teeth: int, tip: float, cx: float):
    segments = 4 * teeth
    ang = 2 * np.pi * (np.arange(segments) + 0.5) / segments
    r_out = np.where(np.isin(np.arange(segments) % 4, (1, 2)), tip - ROOT_DEPTH, tip)
    verts, faces = [], []
    bore = [_ring(verts, BORE_RADIUS, z, ang, cx) for z in RING_Z]
    outer = [_ring(verts, r_out, z, ang, cx) for z in RING_Z]
    for lo, hi in zip(bore, bore[1:]):
        _band(faces, lo, hi, segments, outward=False)  # the bore, facing the axis
    for lo, hi in zip(outer, outer[1:]):
        _band(faces, lo, hi, segments)  # the teeth
    _annulus(faces, bore[0], outer[0], segments, up=False)  # the bottom face, -z
    _annulus(faces, bore[-1], outer[-1], segments, up=True)  # the top face, +z
    return np.asarray(verts), faces


def gear_base(shaft_segments: int = 32):
    (hx, hy), h = PLATE_HALF, BASE_HEIGHT
    verts = [(x, y, z) for z in (0.0, h) for y in (-hy, hy) for x in (-hx, hx)]
    faces = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
    ang = 2 * np.pi * np.arange(shaft_segments) / shaft_segments
    for _, _, x in GEARS.values():
        lo = _ring(verts, SHAFT_RADIUS, h, ang, cx=x)
        hi = _ring(verts, SHAFT_RADIUS, h + SHAFT_HEIGHT, ang, cx=x)
        _band(faces, lo, hi, shaft_segments)
        faces.append(tuple(hi + k for k in range(shaft_segments)))  # the shaft's top, +z
        faces.append(tuple(lo + k for k in reversed(range(shaft_segments))))  # its foot, -z
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
        f.write(f"# {header}\n# written by assets/factory/make_gears_meshes.py\n")
        for v in verts:
            f.write("v {:.9f} {:.9f} {:.9f}\n".format(*v))
        for fc in faces:
            f.write("f " + " ".join(str(i + 1) for i in fc) + "\n")


def main():
    os.makedirs(FACTORY, exist_ok=True)
    os.makedirs(INDUSTREAL, exist_ok=True)
    for name, (teeth, tip, cx) in GEARS.items():
        v, f = gear(teeth, tip, cx)
        ring = np.pi * (tip ** 2 - BORE_RADIUS ** 2) * (GEAR_TOP_Z - BASE_HEIGHT)
        assert 0.8 * ring < signed_volume(v, f) < ring
        folder, file = ((INDUSTREAL, "industreal_gear_large.obj") if name == "large"
                        else (FACTORY, f"factory_gear_{name}_space_5e-4.obj"))
        write_obj(os.path.join(folder, file), v, f,
                  f"{name} gear: {teeth} teeth r {1e3 * (tip - ROOT_DEPTH):.0f}-{1e3 * tip:.0f} mm, bore d "
                  f"{2e3 * BORE_RADIUS:.0f} mm, z 5-25 mm, axis at x = {1e3 * cx:.1f} mm")
    v, f = gear_base()
    plate = 4 * PLATE_HALF[0] * PLATE_HALF[1] * BASE_HEIGHT
    assert plate < signed_volume(v, f) < plate + 3 * np.pi * SHAFT_RADIUS ** 2 * SHAFT_HEIGHT
    write_obj(os.path.join(FACTORY, "factory_gear_base_tight_space_5e-4_subdiv_4x.obj"), v, f,
              "gear base: plate 150 x 50 x 5 mm, shafts d 8 mm x 20 mm at x = 50.5, 20.2, -30.2 mm")


if __name__ == "__main__":
    main()
