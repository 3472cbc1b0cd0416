"""The eager physics step (port of isaacgymenvs_tpu/engine/step.py):
`substeps x solver_iterations` slices of FK -> forward dynamics -> free
velocity -> constraint rows -> contact-impulse solve -> body wrenches ->
velocity clamp -> position update, batched over envs in plain PyTorch.

It is the physics of every model the fused kernel does not cover (geom-geom
pairs, `solver: pgs`, per-env candidate points with terrain or SDF rows, a
model past the kernel's shared memory) and of `sim.use_fused: False`
(`envcore/vec_task.py` chooses the route). Where the kernel freezes the
terrain and SDF planes at the step's entry pose, this step samples them at
every slice, as the JAX package's eager engine does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import contacts as _contacts
from . import dynamics as _dyn
from .dynamics import Kin, SimParams, SimState


class StepOut(NamedTuple):
    state: SimState  # q (N, nq), qd (N, nv) at the step's end
    kin: Kin  # kinematics at the step's end
    body_force: torch.Tensor  # (N, nbody, 3) the last slice's contact force per body
    body_torque: torch.Tensor  # (N, nbody, 3)
    dof_force: torch.Tensor  # (N, nv) the last slice's generalized contact force


def physics_step(
    model,
    state: SimState,
    qfrc: torch.Tensor,
    params: SimParams,
    xfrc: torch.Tensor | None = None,
    plane_friction=1.0,
    q_target: torch.Tensor | None = None,
    terrain=None,
    leaves: dict | None = None,
) -> StepOut:
    """Advance every env by dt = params.dt. qfrc (N, nv) applied generalized
    forces, held over the slices; xfrc (N, nbody, 6) external spatial forces
    (torque about the origin, force; world); q_target (N, nq) PD-drive
    setpoints, re-evaluated every slice; terrain a `dynamics.Terrain`;
    leaves per-env model leaves {name: (N, *leaf.shape)} and "gravity" (N,
    3). The dtype of state.q is the step's."""
    q, qd = state.q, state.qd
    N, dev, dt = q.shape[0], q.device, q.dtype
    meta = _dyn.engine_meta(model, dev, dt)
    masks = (meta.anc, meta.dof_mask)
    n_slices = params.substeps * params.solver_iterations
    h = params.dt / n_slices
    f_ext = q.new_zeros(N, model.nbody, 6) if xfrc is None else xfrc.to(dt)
    qfrc = qfrc.to(dt)
    q_target = None if q_target is None else q_target.to(dt)
    warm = q.new_zeros(N, _contacts.num_constraints(model), 3)
    for _ in range(n_slices):
        kin = _dyn.forward_kinematics(model, q, qd, leaves)
        qdd, minv_mul, _ = _dyn.forward_dynamics(model, q, qd, qfrc, f_ext, params, masks, meta.sq_adr, kin=kin,
                                                 h=h, q_spring=q_target, leaves=leaves)
        qd_free = qd + h * qdd
        con = _contacts.constraint_data(model, kin, meta.anc, plane_friction, terrain=terrain, leaves=leaves)
        sol = _contacts.solve_contacts(model, con, minv_mul, qd_free, h, params, warm=warm)
        bf, bt = _contacts.accumulate_body_wrench(model, con, sol, kin, h)
        qd = torch.clamp(sol.qd, -params.max_dof_velocity, params.max_dof_velocity)
        q = _dyn.integrate_positions(model, q, qd, h, meta)
        warm, qf = sol.impulse, sol.qfrc / h
    kin = _dyn.forward_kinematics(model, q, qd, leaves)
    return StepOut(state=SimState(q=q, qd=qd), kin=kin, body_force=bf, body_torque=bt, dof_force=qf)
