"""Model composition: several articulated Models merged into one scene.

Port of isaacgymenvs_tpu/model/compose.py. Each actor keeps its own
kinematic tree; the merged Model is a forest with offset q / qd addressing,
and the indices of every declaration (bodies, dofs, actuators, candidate
points, geoms, point pairs, anchors, SDF grids and SDF pairs) are offset
with it. Returns the merged model and one `ActorRef` per actor, so that a
task can index its sub-states.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from .spec import Model


class ActorRef(NamedTuple):
    body0: int  # first body index of the actor in the merged model
    q0: int  # first q index
    v0: int  # first qd index
    geom0: int  # first geom index
    nbody: int
    nq: int
    nv: int


_STATIC = (
    "body_parent", "jnt_type", "q_adr", "v_adr", "body_names", "joint_names", "dof_body",
    "actuator_dof", "actuator_names", "cpoint_body", "geom_body", "geom_type", "pair_geom_a",
    "pair_geom_b", "ppair_point", "ppair_geom", "att_body", "tendon_names", "sdf_body",
    "sdf_spacing", "spair_point", "spair_sdf",
)
_LEAVES = (
    "body_pos", "body_quat", "body_ipos", "body_inertia", "body_mass",
    "jnt_axis", "jnt_pos", "armature", "dof_damping", "dof_stiffness",
    "dof_limit_lower", "dof_limit_upper", "dof_limited",
    "dof_max_effort", "dof_max_velocity", "gear", "ctrl_range",
    "geom_pos", "geom_quat", "geom_size", "geom_friction",
    "cpoint_pos", "cpoint_radius", "cpoint_friction", "qpos0",
    "dof_friction",
    "att_offset", "att_target", "tendon_range", "tendon_stiffness",
    "tendon_damping",
)


def compose(models: List[Model], prefixes: List[str] | None = None) -> Tuple[Model, List[ActorRef]]:
    """Concatenate models into one forest; roots stay roots."""
    prefixes = prefixes or ["" for _ in models]
    refs = []
    b_off = q_off = v_off = g_off = cp_off = 0
    cat = {k: [] for k in _STATIC}
    sdf_values: list = []
    sdf_origin: list = []
    leaves = {k: [] for k in _LEAVES}
    for m, pre in zip(models, prefixes):
        refs.append(ActorRef(body0=b_off, q0=q_off, v0=v_off, geom0=g_off, nbody=m.nbody, nq=m.nq, nv=m.nv))
        cat["body_parent"] += [p if p == -1 else p + b_off for p in m.body_parent]
        cat["jnt_type"] += list(m.jnt_type)
        cat["q_adr"] += [a + q_off for a in m.q_adr]
        cat["v_adr"] += [a + v_off for a in m.v_adr]
        cat["body_names"] += [pre + n for n in m.body_names]
        cat["joint_names"] += [pre + n if n else "" for n in m.joint_names]
        cat["dof_body"] += [b + b_off for b in m.dof_body]
        cat["actuator_dof"] += [d + v_off for d in m.actuator_dof]
        cat["actuator_names"] += [pre + n for n in m.actuator_names]
        cat["cpoint_body"] += [b + b_off for b in m.cpoint_body]
        cat["geom_body"] += [b + b_off for b in m.geom_body]
        cat["geom_type"] += list(m.geom_type)
        cat["pair_geom_a"] += [g + g_off for g in m.pair_geom_a]
        cat["pair_geom_b"] += [g + g_off for g in m.pair_geom_b]
        cat["ppair_point"] += [c + cp_off for c in m.ppair_point]
        cat["ppair_geom"] += [g + g_off for g in m.ppair_geom]
        cat["att_body"] += [b + b_off for b in m.att_body]
        cat["tendon_names"] += [pre + n for n in m.tendon_names]
        sdf_off = len(cat["sdf_body"])
        cat["sdf_body"] += [b + b_off for b in m.sdf_body]
        cat["sdf_spacing"] += list(m.sdf_spacing)
        cat["spair_point"] += [c + cp_off for c in m.spair_point]
        cat["spair_sdf"] += [s + sdf_off for s in m.spair_sdf]
        sdf_values += list(m.sdf_values)
        sdf_origin += list(m.sdf_origin)
        for name in _LEAVES:
            leaves[name].append(np.asarray(getattr(m, name)))
        b_off += m.nbody
        q_off += m.nq
        v_off += m.nv
        g_off += m.ngeom
        cp_off += m.ncp

    # tendon_coef is block-diagonal over the dof axis
    tcs, off = [], 0
    for m in models:
        tc = np.asarray(m.tendon_coef)
        if tc.shape[0]:
            wide = np.zeros((tc.shape[0], v_off), np.float32)
            wide[:, off:off + m.nv] = tc
            tcs.append(wide)
        off += m.nv
    tendon_coef = np.concatenate(tcs) if tcs else np.zeros((0, v_off), np.float32)

    merged = Model(
        nbody=b_off,
        nq=q_off,
        nv=v_off,
        nu=len(cat["actuator_dof"]),
        plane_contacts=all(m.plane_contacts for m in models),
        tendon_coef=tendon_coef,
        sdf_values=tuple(sdf_values),
        sdf_origin=tuple(sdf_origin),
        **{k: tuple(v) for k, v in cat.items()},
        **{k: np.concatenate(v).astype(np.float32) for k, v in leaves.items()},
    )
    return merged, refs
