"""URDF parser -> Model (port of isaacgymenvs_tpu/model/urdf.py).

Host-side numpy. Covers the subset the bundled `cartpole.urdf` uses and
what comes with it at no cost:

  * links with <inertial> (mass, origin, inertia) and box / sphere /
    cylinder / capsule <collision> geometry; URDF <box size> is FULL
    extents (MJCF uses half sizes);
  * fixed / prismatic / revolute / continuous / floating joints with
    origin, axis, <limit> and <dynamics damping= friction=>;
  * `fix_base`: the root link is welded to the world;
  * `collapse_fixed`: a link on a fixed joint is folded into its parent
    (the collapse_fixed_joints asset option): its mass, com and inertia
    merge into the parent's (`ModelBuilder.merge_body`), its collision
    geoms move to the parent under the joint's transform, and its children
    attach to the parent with the accumulated transform;
  * a link with a mass but no (or a zero) <inertia> tensor gets its
    rotational inertia from its collision shapes scaled to that mass; a
    link with no <inertial> gets mass and inertia from its collision
    shapes at `default_density`; <density value=> inside <inertial> gives
    the mass from the collision volume;
  * <mesh filename= scale=> collision geometry (Wavefront OBJ, binary or
    ASCII STL; a `package://` prefix is dropped) becomes a MESH geom: its
    half-extents are the mesh's axis-aligned bounding box (at least 1e-5),
    the geom frame moves to the box's centre, and 4 farthest-point vertices
    become its contact candidates. A mesh file is looked up in the URDF's
    directory and its three parents; one that is missing or fails to load
    drops the geom, as the JAX package does. For mass and inertia a mesh
    counts as its bounding box.
"""
from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET

import numpy as np

from . import spec
from .mjcf import _quat_to_mat_xyzw
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

_JOINT_MAP = {
    "revolute": HINGE,
    "continuous": HINGE,
    "prismatic": SLIDE,
    "fixed": FIXED,
    "floating": FREE,
}

_UNIT_INERTIA = {
    GEOM_SPHERE: lambda size: spec.sphere_inertia(1.0, size[0]),
    GEOM_CAPSULE: lambda size: spec.capsule_inertia(1.0, size[0], size[1]),
    GEOM_BOX: lambda size: spec.box_inertia(1.0, size),
    GEOM_CYLINDER: lambda size: spec.cylinder_inertia(1.0, size[0], size[1]),
    GEOM_MESH: lambda size: spec.box_inertia(1.0, size),
}


def _fv(s, n=None):
    v = np.array(s.split(), dtype=np.float64)
    if n is not None and v.size != n:
        raise ValueError(f"expected {n} floats, got {s!r}")
    return v


def _quat_from_rpy(rpy):
    r, p, y = rpy
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    cr, sr = np.cos(r / 2), np.sin(r / 2)
    cp, sp = np.cos(p / 2), np.sin(p / 2)
    return np.array([
        cy * sr * cp - sy * cr * sp,
        cy * cr * sp + sy * sr * cp,
        sy * cr * cp - cy * sr * sp,
        cy * cr * cp + sy * sr * sp,
    ])


def _origin(elem):
    if elem is None:
        return np.zeros(3), np.array([0.0, 0, 0, 1])
    xyz = _fv(elem.get("xyz", "0 0 0"), 3)
    rpy = _fv(elem.get("rpy", "0 0 0"), 3)
    return xyz, _quat_from_rpy(rpy)


def _load_obj_vertices(path: str, scale) -> np.ndarray:
    """Wavefront OBJ -> its vertices (V, 3) * scale."""
    verts = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                t = line.split()
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    return np.asarray(verts, np.float64) * scale


def _load_stl(path: str, scale) -> np.ndarray:
    """Binary or ASCII STL -> its unique vertices (V, 3) * scale. A file that
    starts with "solid" is read as ASCII unless its size is that of a binary
    file with the triangle count of its header."""
    with open(path, "rb") as f:
        head = f.read(80)
        if head[:5].lower() == b"solid":
            raw = f.read(4)
            if len(raw) == 4 and os.path.getsize(path) != 84 + 50 * struct.unpack("<I", raw)[0]:
                verts = []
                with open(path, "r", errors="ignore") as tf:
                    for line in tf:
                        t = line.split()
                        if t[:1] == ["vertex"]:
                            verts.append([float(t[1]), float(t[2]), float(t[3])])
                return np.unique(np.asarray(verts, np.float64), axis=0) * scale
        f.seek(80)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(50 * n), dtype=np.uint8)
        tri = data.reshape(n, 50)[:, :48].copy().view("<f4").reshape(n, 4, 3)
        v = tri[:, 1:4].reshape(-1, 3).astype(np.float64)
    return np.unique(np.round(v, 7), axis=0) * scale


def _farthest_points(verts: np.ndarray, k: int) -> np.ndarray:
    """Greedy farthest-point subsample of k mesh vertices, starting from the
    one farthest from their mean: a mesh geom's contact candidates."""
    if len(verts) <= k:
        return verts
    sel = [int(np.argmax(np.linalg.norm(verts - verts.mean(0), axis=1)))]
    d = np.linalg.norm(verts - verts[sel[0]], axis=1)
    for _ in range(k - 1):
        i = int(np.argmax(d))
        sel.append(i)
        d = np.minimum(d, np.linalg.norm(verts - verts[i], axis=1))
    return verts[sel]


def _mesh_vertices(mesh, mesh_dirs):
    """The scaled vertices of a <mesh>, or None when its file is missing,
    of another format, or fails to load."""
    fname = mesh.get("filename", "")
    if fname.startswith("package://"):
        fname = fname[len("package://"):]
    scale = _fv(mesh.get("scale", "1 1 1"))
    if scale.size == 1:
        scale = np.repeat(scale, 3)
    for d in mesh_dirs:
        path = os.path.join(d, fname)
        if os.path.exists(path):
            try:
                if fname.lower().endswith(".obj"):
                    return _load_obj_vertices(path, scale)
                if fname.lower().endswith(".stl"):
                    return _load_stl(path, scale)
            except Exception:
                return None
            return None
    return None


def _parse_geometry(geo_elem, mesh_dirs=()):
    """(gtype, size3, mesh) of a <geometry>, or None when it holds no shape
    or an unloadable mesh; `mesh` is (the bounding box's centre, 4 contact
    candidates about it) for a mesh, else None."""
    if geo_elem is None:
        return None
    mesh = geo_elem.find("mesh")
    if mesh is not None:
        verts = _mesh_vertices(mesh, mesh_dirs)
        if verts is None or len(verts) == 0:
            return None
        lo, hi = verts.min(0), verts.max(0)
        center = (hi + lo) / 2.0
        return GEOM_MESH, np.maximum((hi - lo) / 2.0, 1e-5), (center, _farthest_points(verts, 4) - center)
    box = geo_elem.find("box")
    if box is not None:
        return GEOM_BOX, _fv(box.get("size"), 3) / 2.0, None
    sph = geo_elem.find("sphere")
    if sph is not None:
        return GEOM_SPHERE, np.array([float(sph.get("radius")), 0, 0]), None
    for tag, gtype in (("cylinder", GEOM_CYLINDER), ("capsule", GEOM_CAPSULE)):
        el = geo_elem.find(tag)
        if el is not None:
            return gtype, np.array([float(el.get("radius")), float(el.get("length")) / 2.0, 0]), None
    return None


def _quat_mul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def _quat_rot(q, v):
    xyz, w = q[:3], q[3]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _shape_inertia(geoms, com, scale):
    """Inertia about `com` of the collision shapes at `scale` x unit density."""
    total = np.zeros((3, 3))
    for gtype, gpos, gquat, gsize, _ in geoms:
        m_u, i_u = _UNIT_INERTIA[gtype](gsize)
        R = _quat_to_mat_xyzw(gquat)
        d = gpos - com
        total += R @ (i_u * scale) @ R.T + m_u * scale * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return total


def _link_props(link_elem, default_density, mesh_dirs=()):
    """mass, com, inertia (3x3 about the com, link frame), collision geoms
    (gtype, pos, quat, size, mesh candidates or None)."""
    geoms = []
    for col in link_elem.findall("collision"):
        g = _parse_geometry(col.find("geometry"), mesh_dirs)
        if g is not None:
            gpos, gquat = _origin(col.find("origin"))
            points = None
            if g[2] is not None:  # the geom frame moves to the mesh's bounding-box centre
                center, points = g[2]
                gpos = gpos + _quat_rot(gquat, center)
            geoms.append((g[0], gpos, gquat, g[1], points))
    unit_mass = sum(_UNIT_INERTIA[gt](gs)[0] for gt, _, _, gs, _ in geoms)
    inertial = link_elem.find("inertial")
    mass, com, inertia = 0.0, np.zeros(3), np.zeros((3, 3))
    if inertial is None:
        if geoms:
            mass = unit_mass * default_density
            if mass > 0:
                com = sum(_UNIT_INERTIA[gt](gs)[0] * default_density * gp for gt, gp, _, gs, _ in geoms) / mass
            inertia = _shape_inertia(geoms, com, default_density)
        return mass, com, inertia, geoms
    mass_el = inertial.find("mass")
    mass = float(mass_el.get("value")) if mass_el is not None else 0.0
    dens_el = inertial.find("density")
    if mass == 0.0 and dens_el is not None:
        mass = unit_mass * float(dens_el.get("value", 1000.0))
    com, _ = _origin(inertial.find("origin"))
    it = inertial.find("inertia")
    if it is not None:
        ixx, iyy, izz, ixy, ixz, iyz = (float(it.get(k, 0)) for k in ("ixx", "iyy", "izz", "ixy", "ixz", "iyz"))
        inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    if np.allclose(inertia, 0.0) and mass > 0 and geoms:
        inertia = _shape_inertia(geoms, com, mass / max(unit_mass, 1e-12))
    return mass, com, inertia, geoms


def load_urdf(
    path: str,
    fix_base: bool = False,
    default_friction: float = 1.0,
    collapse_fixed: bool = False,
    default_density: float = 1000.0,
) -> Model:
    # mesh files resolve against the URDF's directory and its three parents
    d = os.path.dirname(os.path.abspath(path))
    mesh_dirs = [d]
    for _ in range(3):
        mesh_dirs.append(os.path.dirname(mesh_dirs[-1]))
    return parse_urdf(
        ET.parse(path).getroot(),
        fix_base=fix_base,
        default_friction=default_friction,
        collapse_fixed=collapse_fixed,
        default_density=default_density,
        mesh_dirs=tuple(mesh_dirs),
    )


def parse_urdf(
    root: ET.Element,
    fix_base: bool = False,
    default_friction: float = 1.0,
    collapse_fixed: bool = False,
    default_density: float = 1000.0,
    mesh_dirs=(),
) -> Model:
    links = {l.get("name"): l for l in root.findall("link")}
    children_of, child_links = {}, set()
    for j in root.findall("joint"):
        children_of.setdefault(j.find("parent").get("link"), []).append(j)
        child_links.add(j.find("child").get("link"))
    roots = [n for n in links if n not in child_links]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, got {roots}")

    b = ModelBuilder()

    def add_link(link_name, parent_idx, jnt_elem, t_pos=(0.0, 0.0, 0.0), t_quat=(0.0, 0.0, 0.0, 1.0)):
        # (t_pos, t_quat): the transform of collapsed fixed-joint ancestors,
        # in the frame of body `parent_idx`
        t_pos, t_quat = np.asarray(t_pos, np.float64), np.asarray(t_quat, np.float64)
        mass, com, inertia, geoms = _link_props(links[link_name], default_density, mesh_dirs)
        if collapse_fixed and jnt_elem is not None and jnt_elem.get("type") == "fixed" and parent_idx >= 0:
            jpos, jquat = _origin(jnt_elem.find("origin"))
            pos = t_pos + _quat_rot(t_quat, jpos)
            quat = _quat_mul(t_quat, jquat)
            if mass > 0:
                R = _quat_to_mat_xyzw(quat)
                b.merge_body(parent_idx, mass, pos + _quat_rot(quat, com), R @ inertia @ R.T)
            for gtype, gpos, gquat, gsize, points in geoms:
                b.add_geom(parent_idx, gtype, pos + _quat_rot(quat, gpos), _quat_mul(quat, gquat), gsize,
                           default_friction, mesh_points=points)
            for child_joint in children_of.get(link_name, []):
                add_link(child_joint.find("child").get("link"), parent_idx, child_joint, pos, quat)
            return
        rng, damping, fric, max_eff, max_vel = (None, None), 0.0, 0.0, np.inf, np.inf
        if jnt_elem is None:  # root link
            jtype = FIXED if fix_base else FREE
            pos, quat = np.zeros(3), np.array([0.0, 0, 0, 1])
            axis = np.array([0.0, 0, 1])
            jname = f"{link_name}_root"
        else:
            jtype = _JOINT_MAP[jnt_elem.get("type")]
            pos, quat = _origin(jnt_elem.find("origin"))
            pos, quat = t_pos + _quat_rot(t_quat, pos), _quat_mul(t_quat, quat)
            ax = jnt_elem.find("axis")
            axis = _fv(ax.get("xyz"), 3) if ax is not None else np.array([1.0, 0, 0])
            n = np.linalg.norm(axis)
            axis = axis / n if n > 0 else np.array([1.0, 0, 0])
            jname = jnt_elem.get("name")
            lim = jnt_elem.find("limit")
            if lim is not None:
                if jnt_elem.get("type") != "continuous" and lim.get("lower") is not None:
                    rng = (float(lim.get("lower")), float(lim.get("upper")))
                if lim.get("effort") is not None:
                    max_eff = float(lim.get("effort"))
                if lim.get("velocity") is not None:
                    max_vel = float(lim.get("velocity"))
            dyn = jnt_elem.find("dynamics")
            if dyn is not None:
                damping = float(dyn.get("damping", 0))
                fric = float(dyn.get("friction", 0))  # Coulomb joint friction
        idx = b.add_body(
            parent=parent_idx,
            name=link_name,
            pos=pos,
            quat=quat,
            jnt_type=jtype,
            jnt_axis=axis,
            jnt_pos=np.zeros(3),  # URDF joints anchor at the child frame origin
            joint_name=jname,
            mass=mass,
            ipos=com,
            inertia=inertia,
            damping=damping,
            friction_loss=fric,
            limit=rng,
            max_effort=max_eff,
            max_velocity=max_vel,
        )
        for gtype, gpos, gquat, gsize, points in geoms:
            b.add_geom(idx, gtype, gpos, gquat, gsize, default_friction, mesh_points=points)
        for child_joint in children_of.get(link_name, []):
            add_link(child_joint.find("child").get("link"), idx, child_joint)

    add_link(roots[0], -1, None)
    return b.finalize()
