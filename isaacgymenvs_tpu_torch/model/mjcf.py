"""MJCF (MuJoCo XML) parser -> Model (port of isaacgymenvs_tpu/model/mjcf.py).

Host-side numpy. Covers the subset the Ant asset uses and what the JAX
parser shares with it:

  * <compiler angle= inertiafromgeom= />
  * <default> trees with named classes and childclass inheritance
  * nested <body> with pos/quat/euler/axisangle/zaxis, <freejoint>/<joint>
    (hinge, slide, free); several joints per body expand into chains of
    massless links
  * <geom> sphere/capsule/box/cylinder with fromto/pos/quat, density or an
    explicit <inertial>; plane geoms are the engine's ground
  * <asset><mesh> STL files (binary or ASCII, with `scale`) and mesh geoms:
    a MESH geom of the vertices' axis-aligned box, its frame moved to the
    box's centre, with 6 farthest-point vertices as contact candidates and
    the box's inertia; a mesh that is missing, of another format or
    unreadable drops its geom
  * <actuator> motor/position/general/velocity with gear and ctrlrange
  * <tendon><fixed> joint couplings
  * <custom><numeric name="init_qpos"> (MuJoCo wxyz -> internal xyzw)

Angles are converted to radians; MuJoCo quats (wxyz) to xyzw.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from . import spec
from .spec import (
    FIXED,
    FREE,
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_MESH,
    GEOM_SPHERE,
    HINGE,
    SLIDE,
    Model,
    ModelBuilder,
)

_GEOM_TYPES = {
    "sphere": GEOM_SPHERE,
    "capsule": GEOM_CAPSULE,
    "box": GEOM_BOX,
    "cylinder": GEOM_CYLINDER,
}

_JOINT_TYPES = {"hinge": HINGE, "slide": SLIDE, "free": FREE}


def _fv(s, n=None):
    v = np.array(s.split(), dtype=np.float64)
    if n is not None and v.size != n:
        raise ValueError(f"expected {n} floats, got {s!r}")
    return v


def _quat_wxyz_to_xyzw(q):
    q = np.asarray(q, np.float64)
    return np.array([q[1], q[2], q[3], q[0]], np.float64)


def _rot_from_zaxis(z):
    """Quaternion (xyzw) rotating +z to the given direction."""
    z = np.asarray(z, np.float64)
    n = np.linalg.norm(z)
    if n < 1e-12:
        return np.array([0, 0, 0, 1.0])
    z = z / n
    c = float(z[2])
    if c > 1 - 1e-12:
        return np.array([0, 0, 0, 1.0])
    if c < -1 + 1e-12:
        return np.array([1.0, 0, 0, 0.0])  # 180 deg about x
    axis = np.cross(np.array([0.0, 0.0, 1.0]), z)
    axis = axis / np.linalg.norm(axis)
    half = np.arccos(np.clip(c, -1, 1)) / 2
    return np.concatenate([axis * np.sin(half), [np.cos(half)]])


def _quat_mul_xyzw(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def _quat_to_mat_xyzw(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class _Defaults:
    """MJCF default-class resolution: class -> element tag -> attr dict."""

    def __init__(self):
        self.classes = {"__top__": {}}
        self.parents = {"__top__": None}

    def parse(self, default_elem, parent="__top__"):
        cls = default_elem.get("class", "__top__" if parent == "__top__" else None)
        if cls is None:
            raise ValueError("nested <default> must have a class name")
        self.classes.setdefault(cls, {})
        self.parents[cls] = parent if cls != "__top__" else None
        for child in default_elem:
            if child.tag == "default":
                self.parse(child, parent=cls)
            else:
                self.classes[cls].setdefault(child.tag, {}).update(child.attrib)

    def resolve(self, tag, elem_attrib, active_class):
        """Merge defaults along the class chain, then the element's own attrs."""
        chain = []
        c = active_class
        while c is not None:
            chain.append(c)
            c = self.parents.get(c)
        merged = {}
        for c in reversed(chain):
            merged.update(self.classes.get(c, {}).get(tag, {}))
        merged.update(elem_attrib)
        return merged


def _parse_orientation(attrs, deg2rad):
    """body/geom orientation from quat/euler/axisangle/zaxis (xyzw out)."""
    if "quat" in attrs:
        return _quat_wxyz_to_xyzw(_fv(attrs["quat"], 4))
    if "euler" in attrs:
        e = _fv(attrs["euler"], 3) * deg2rad
        # MuJoCo's default eulerseq "xyz" is intrinsic: R = Rx @ Ry @ Rz
        qx = np.array([np.sin(e[0] / 2), 0, 0, np.cos(e[0] / 2)])
        qy = np.array([0, np.sin(e[1] / 2), 0, np.cos(e[1] / 2)])
        qz = np.array([0, 0, np.sin(e[2] / 2), np.cos(e[2] / 2)])
        return _quat_mul_xyzw(qx, _quat_mul_xyzw(qy, qz))
    if "axisangle" in attrs:
        aa = _fv(attrs["axisangle"], 4)
        axis = aa[:3] / max(np.linalg.norm(aa[:3]), 1e-12)
        half = aa[3] * deg2rad / 2
        return np.concatenate([axis * np.sin(half), [np.cos(half)]])
    if "zaxis" in attrs:
        return _rot_from_zaxis(_fv(attrs["zaxis"], 3))
    return np.array([0.0, 0.0, 0.0, 1.0])


def _geom_frame_and_size(attrs, deg2rad):
    """(gtype, pos, quat_xyzw, size3), handling fromto."""
    gtype = _GEOM_TYPES[attrs.get("type", "sphere")]
    size_v = _fv(attrs.get("size", "0 0 0"))
    if "fromto" in attrs:
        ft = _fv(attrs["fromto"], 6)
        p1, p2 = ft[:3], ft[3:]
        pos = 0.5 * (p1 + p2)
        quat = _rot_from_zaxis(p2 - p1)
        size = np.array([size_v[0], 0.5 * np.linalg.norm(p2 - p1), 0.0])
    else:
        pos = _fv(attrs.get("pos", "0 0 0"), 3)
        quat = _parse_orientation(attrs, deg2rad)
        size = np.zeros(3)
        size[: size_v.size] = size_v
    return gtype, pos, quat, size


def _geom_mass_inertia(gtype, size, density):
    if gtype == GEOM_SPHERE:
        return spec.sphere_inertia(density, size[0])
    if gtype == GEOM_CAPSULE:
        return spec.capsule_inertia(density, size[0], size[1])
    if gtype == GEOM_BOX:
        return spec.box_inertia(density, size)
    return spec.cylinder_inertia(density, size[0], size[1])


def load_mjcf(path: str) -> Model:
    return parse_mjcf(ET.parse(path).getroot(), base_dir=os.path.dirname(path))


def parse_mjcf(root: ET.Element, base_dir: str = ".") -> Model:
    compiler = root.find("compiler")
    angle = compiler.get("angle", "degree") if compiler is not None else "degree"
    deg2rad = np.pi / 180.0 if angle == "degree" else 1.0

    # <include> anywhere, position-preserving
    expanded = True
    while expanded:
        expanded = False
        for parent in root.iter():
            for idx, child in enumerate(list(parent)):
                if child.tag == "include":
                    sub = ET.parse(os.path.join(base_dir, child.get("file"))).getroot()
                    parent.remove(child)
                    for j, sc in enumerate(list(sub)):
                        parent.insert(idx + j, sc)
                    expanded = True
                    break
            if expanded:
                break

    defaults = _Defaults()
    for d in root.findall("default"):
        defaults.parse(d)

    from .urdf import _farthest_points, _load_stl, _quat_rot  # urdf imports this module

    # asset meshes (STL): name -> scaled vertices
    meshdir = compiler.get("meshdir", ".") if compiler is not None else "."
    meshes = {}
    for asset in root.findall("asset"):
        for m in asset.findall("mesh"):
            file = m.get("file")
            if file is None or not file.lower().endswith(".stl"):
                continue
            scale = _fv(m.get("scale", "1 1 1"))
            if scale.size == 1:
                scale = np.repeat(scale, 3)
            path = os.path.join(base_dir, meshdir, file)
            if os.path.exists(path):
                try:
                    meshes[m.get("name", os.path.splitext(os.path.basename(file))[0])] = _load_stl(path, scale)
                except Exception:
                    pass

    b = ModelBuilder()
    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF missing <worldbody>")

    def parse_body(elem: ET.Element, parent_idx: int, active_class: str):
        attrs = elem.attrib
        cls = attrs.get("childclass", active_class)
        name = attrs.get("name", f"body{len(b.body_parent)}")
        pos = _fv(attrs.get("pos", "0 0 0"), 3)
        quat = _parse_orientation(attrs, deg2rad)

        joints = [
            defaults.resolve("joint", j.attrib, j.attrib.get("class", cls))
            for j in elem.findall("joint")
        ]
        for j in elem.findall("freejoint"):
            joints.append({"type": "free", "name": j.get("name", name + "_free")})

        # (gtype, pos, quat, size, mass, inertia_com, fric, contype, conaffinity, mesh candidates)
        geom_data = []
        for g in elem.findall("geom"):
            ga = defaults.resolve("geom", g.attrib, g.attrib.get("class", cls))
            gt_name = ga.get("type", "sphere")
            if gt_name == "plane":
                continue  # the static world plane is the engine's ground
            density = float(ga.get("density", 1000.0))
            fric = float(_fv(ga.get("friction", "1 0.005 0.0001"))[0])
            points = None
            if gt_name == "mesh":
                verts = meshes.get(ga.get("mesh"))
                if verts is None or len(verts) == 0:
                    continue  # a missing or unreadable mesh drops its geom
                lo, hi = verts.min(0), verts.max(0)
                gsize = np.maximum((hi - lo) / 2.0, 1e-5)  # the bounding box's half extents
                center = (hi + lo) / 2.0
                gquat = _parse_orientation(ga, deg2rad)
                # the geom frame moves to the box's centre; the candidates follow
                gpos = _fv(ga.get("pos", "0 0 0"), 3) + _quat_rot(gquat, center)
                gtype, points = GEOM_MESH, _farthest_points(verts, 6) - center
                m, icom = spec.box_inertia(density, gsize)
            else:
                gtype, gpos, gquat, gsize = _geom_frame_and_size(ga, deg2rad)
                m, icom = _geom_mass_inertia(gtype, gsize, density)
            geom_data.append((
                gtype, gpos, gquat, gsize, m, icom, fric,
                int(ga.get("contype", 1)), int(ga.get("conaffinity", 1)), points,
            ))

        inertial_elem = elem.find("inertial")
        total_mass = 0.0
        com = np.zeros(3)
        if inertial_elem is not None:
            total_mass = float(inertial_elem.get("mass"))
            com = _fv(inertial_elem.get("pos", "0 0 0"), 3)
            iquat = _parse_orientation(inertial_elem.attrib, deg2rad)
            if "diaginertia" in inertial_elem.attrib:
                i_local = np.diag(_fv(inertial_elem.get("diaginertia"), 3))
            elif "fullinertia" in inertial_elem.attrib:
                fi = _fv(inertial_elem.get("fullinertia"), 6)
                i_local = np.array([
                    [fi[0], fi[3], fi[4]], [fi[3], fi[1], fi[5]], [fi[4], fi[5], fi[2]],
                ])
            else:
                i_local = np.zeros((3, 3))
            R = _quat_to_mat_xyzw(iquat)
            inertia = R @ i_local @ R.T
        else:
            # accumulate from the geoms
            for _gt, gpos, _gq, _gs, m, _ic, _f, _ct, _ca, _mp in geom_data:
                total_mass += m
                com = com + m * gpos
            if total_mass > 0:
                com = com / total_mass
            inertia = np.zeros((3, 3))
            for _gt, gpos, gquat, _gs, m, icom, _f, _ct, _ca, _mp in geom_data:
                R = _quat_to_mat_xyzw(gquat)
                d = gpos - com
                inertia = inertia + R @ icom @ R.T + m * (
                    np.dot(d, d) * np.eye(3) - np.outer(d, d)
                )

        # expand joints into a chain of links; the last link carries mass+geoms
        njoints = max(len(joints), 1)
        body_idx = parent_idx
        for k in range(njoints):
            is_last = k == njoints - 1
            if joints:
                ja = joints[k]
                jtype = _JOINT_TYPES[ja.get("type", "hinge")]
                jname = ja.get("name", f"{name}_jnt{k}")
                jaxis = _fv(ja.get("axis", "0 0 1"), 3)
                n = np.linalg.norm(jaxis)
                jaxis = jaxis / n if n > 0 else np.array([0, 0, 1.0])
                jpos = _fv(ja.get("pos", "0 0 0"), 3)
                limited = ja.get("limited", "auto") in ("true", "1", "auto")
                rng = (None, None)
                if "range" in ja and limited and jtype != FREE:
                    # 'auto' follows MJCF autolimits: a range implies limits
                    r = _fv(ja["range"], 2)
                    if jtype == HINGE:
                        r = r * deg2rad
                    rng = (r[0], r[1])
                armature = float(ja.get("armature", 0.0))
                damping = float(ja.get("damping", 0.0))
                fric = float(ja.get("frictionloss", 0.0))
                stiffness = float(ja.get("stiffness", 0.0))
                ref = float(ja.get("ref", 0.0)) * (deg2rad if jtype == HINGE else 1.0)
            else:
                jtype, jname, jaxis, jpos = FIXED, "", np.array([0, 0, 1.0]), np.zeros(3)
                rng, armature, damping, stiffness, ref, fric = (None, None), 0.0, 0.0, 0.0, 0.0, 0.0

            body_idx = b.add_body(
                parent=body_idx,
                name=name if is_last else f"{name}__f{k}",
                pos=pos if k == 0 else np.zeros(3),
                quat=quat if k == 0 else np.array([0, 0, 0, 1.0]),
                jnt_type=jtype,
                jnt_axis=jaxis,
                jnt_pos=jpos,
                joint_name=jname,
                mass=total_mass if is_last else 0.0,
                ipos=com if is_last else np.zeros(3),
                inertia=inertia if is_last else np.zeros((3, 3)),
                armature=armature,
                damping=damping,
                friction_loss=fric,
                stiffness=stiffness,
                limit=rng,
            )
            if joints and jtype in (HINGE, SLIDE):
                b.qpos0_scalar[body_idx] = ref

        for gtype, gpos, gquat, gsize, _m, _ic, fric, contype, conaffinity, points in geom_data:
            if contype == 0 and conaffinity == 0:
                continue  # visual-only
            b.add_geom(body_idx, gtype, gpos, gquat, gsize, fric, mesh_points=points)

        for child in elem.findall("body"):
            parse_body(child, body_idx, cls)

    for body_elem in worldbody.findall("body"):
        parse_body(body_elem, -1, "__top__")

    # dof index of a joint's first dof (mirrors finalize's joint_to_dof)
    jdof = {}
    d = 0
    for i in range(len(b.body_parent)):
        if b.joint_names[i] and b.joint_names[i] not in jdof:
            jdof[b.joint_names[i]] = d
        d += spec.vdim(b.jnt_type[i])
    for act_root in root.findall("actuator"):
        for m in act_root:
            if m.tag not in ("motor", "general", "position", "velocity"):
                continue
            ma = defaults.resolve(m.tag, m.attrib, m.attrib.get("class", "__top__"))
            if m.tag != "motor":
                # <position>/<general> defaults may live under the "general" tag
                ga2 = defaults.resolve("general", m.attrib, m.attrib.get("class", "__top__"))
                ga2.update(ma)
                ma = ga2
            joint = ma.get("joint")
            if joint is None or joint not in jdof:
                continue
            cr = _fv(ma["ctrlrange"], 2) if "ctrlrange" in ma else None
            b.add_actuator(joint, float(_fv(ma.get("gear", "1"))[0]), cr, name=m.get("name", joint))
            if m.tag == "position":
                # kp is the dof's PD stiffness; forcerange its effort clamp
                di = jdof[joint]
                b.dof_stiffness[di] = float(ma.get("kp", 1.0))
                if "forcerange" in ma:
                    fr = _fv(ma["forcerange"], 2)
                    b.dof_max_effort[di] = float(max(abs(fr[0]), abs(fr[1])))

    for tr in root.findall("tendon"):
        for fx in tr.findall("fixed"):
            joints = [(tj.get("joint"), float(tj.get("coef", 1.0))) for tj in fx.findall("joint")]
            rng = _fv(fx.get("range", "0 0"), 2)
            b.add_tendon(fx.get("name", f"tendon{len(b.tendons)}"), joints, (rng[0], rng[1]))

    model = b.finalize()

    # custom init_qpos (MuJoCo order: free joints are pos + wxyz quat)
    custom = root.find("custom")
    if custom is not None:
        for num in custom.findall("numeric"):
            if num.get("name") != "init_qpos":
                continue
            vals = _fv(num.get("data"))
            q0 = np.array(model.qpos0)
            src = 0
            for i in range(model.nbody):
                jt, adr = model.jnt_type[i], model.q_adr[i]
                if jt == FREE:
                    q0[adr:adr + 3] = vals[src:src + 3]
                    q0[adr + 3:adr + 7] = _quat_wxyz_to_xyzw(vals[src + 3:src + 7])
                    src += 7
                elif jt in (HINGE, SLIDE):
                    q0[adr] = vals[src]
                    src += 1
            model = model.replace(qpos0=q0.astype(np.float32))
    return model
