"""Anymal: velocity-command tracking on flat ground (port of
isaacgymenvs_tpu/tasks/anymal.py), batched over envs.

The robot is the URDF `urdf/anymal_c/urdf/anymal.urdf` with its fixed
joints collapsed; the package carries a hand-written stand-in of ANYmal C
made of primitives (see assets/). Actions are PD position targets about the
default joint angles (stiffness and damping become the dofs' implicit
spring and damper), commands are drawn per reset, the reward is the
exponential tracking of the commanded base velocities minus a torque cost,
clipped at 0, and an episode ends when the base or a knee touches the
ground, or at its length.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import maths
from ..envcore.vec_task import VecTask
from ..model import load_urdf
from ..utils.assets import asset_path


class Anymal(VecTask):
    use_pd_targets = True
    uses_kin = False

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        learn = env.get("learn", {})
        control = env.get("control", {})
        self.lin_vel_scale = float(learn.get("linearVelocityScale", 2.0))
        self.ang_vel_scale = float(learn.get("angularVelocityScale", 0.25))
        self.dof_pos_scale = float(learn.get("dofPositionScale", 1.0))
        self.dof_vel_scale = float(learn.get("dofVelocityScale", 0.05))
        self.rew_lin_vel_xy_scale = float(learn.get("linearVelocityXYRewardScale", 1.0))
        self.rew_ang_vel_z_scale = float(learn.get("angularVelocityZRewardScale", 0.5))
        self.rew_torque_scale = float(learn.get("torqueRewardScale", -0.000025))
        self.kp = float(control.get("stiffness", 85.0))
        self.kd = float(control.get("damping", 2.0))
        self.action_scale = float(control.get("actionScale", 0.5))
        cr = env.get("randomCommandVelocityRanges", {})
        self.cmd_ranges = [tuple(cr.get("linear_x", (-2.0, 2.0))), tuple(cr.get("linear_y", (-1.0, 1.0))),
                           tuple(cr.get("yaw", (-1.0, 1.0)))]
        self.base_init_pos = np.asarray(env.get("baseInitState", {}).get("pos", [0.0, 0.0, 0.62]), np.float32)
        env.setdefault("controlFrequencyInv", int(control.get("controlFrequencyInv", 1)))
        dt = float(cfg.get("sim", {}).get("dt", 0.02))
        ep_s = float(learn.get("episodeLength_s", 50.0))
        env.setdefault("episodeLength", int(ep_s / (dt * int(env.get("controlFrequencyInv", 1))) + 0.5))
        self.num_obs = 48
        self.num_acts = 12
        super().__init__(cfg, device)

        m, dev = self.model, self.device
        sdofs = self.scalar_dof_indices
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.dof_idx = long(sdofs)
        self.dof_q_idx = long([m.q_adr[m.dof_body[d]] for d in sdofs])
        # default joint angles by joint name (Anymal.yaml defaultJointAngles)
        angles = env.get("defaultJointAngles", {})
        self.default_dof_pos = f32([float(angles.get(m.joint_names[m.dof_body[d]], 0.0)) for d in sdofs])
        # termination bodies: the base and the knees (THIGH links)
        self.base_body = 0
        self.knee_bodies = long([i for i, n in enumerate(m.body_names) if "THIGH" in n])
        self.qpos0 = f32(m.qpos0)
        self.cmd_lo = f32([r[0] for r in self.cmd_ranges])
        self.cmd_hi = f32([r[1] for r in self.cmd_ranges])
        self.down = f32([0.0, 0.0, -1.0])
        self.cmd_scale = f32([self.lin_vel_scale, self.lin_vel_scale, self.ang_vel_scale])

    def build_model(self):
        asset = self.cfg["env"].get("urdfAsset", {}).get("file", "urdf/anymal_c/urdf/anymal.urdf")
        # links without <inertial> at density 0.001, as the reference loads it
        m = load_urdf(asset_path(asset), collapse_fixed=True, default_density=0.001)
        # the PD drive gains as the scalar dofs' stiffness and damping (the
        # physics integrates them implicitly)
        stiff = np.zeros(m.nv, np.float32)
        damp = np.zeros(m.nv, np.float32)
        for i, t in enumerate(m.jnt_type):
            if t in (1, 2):
                stiff[m.v_adr[i]] = self.kp
                damp[m.v_adr[i]] = self.kd
        m = m.replace(dof_stiffness=stiff, dof_damping=damp)
        return self._prune_contact_points(m), self.sim_params_from_cfg()

    @staticmethod
    def _prune_contact_points(m):
        """Keep the ground candidates that matter: the foot spheres (on the
        SHANK bodies), the first 8 points of each THIGH (the knee cylinder,
        for termination) and the first 8 radius-0 points of the base (its box
        corners)."""
        keep, kept = [], {}
        for c in range(m.ncp):
            body = m.cpoint_body[c]
            name = m.body_names[body]
            r = float(m.cpoint_radius[c])
            k = kept.get(body, 0)
            if "SHANK" in name and r > 0.0:
                keep.append(c)
            elif "THIGH" in name and k < 8:
                keep.append(c)
                kept[body] = k + 1
            elif body == 0 and k < 8 and r == 0.0:
                keep.append(c)
                kept[body] = k + 1
        keep = np.asarray(keep)
        return m.replace(
            cpoint_body=tuple(m.cpoint_body[c] for c in keep),
            cpoint_pos=m.cpoint_pos[keep],
            cpoint_radius=m.cpoint_radius[keep],
            cpoint_friction=m.cpoint_friction[keep],
        )

    # ---- init / reset ---------------------------------------------------
    def sample_init(self, generator, n):
        u = lambda *shape: torch.rand(*shape, generator=generator, device=self.device)
        # dof_pos = default x U(0.5, 1.5), dof_vel ~ U(-0.1, 0.1)
        dof_pos = self.default_dof_pos * (0.5 + u(n, 12))
        dof_vel = -0.1 + 0.2 * u(n, 12)
        q = self.qpos0.repeat(n, 1)
        q[:, 0:3] = torch.as_tensor(self.base_init_pos, device=self.device)
        q[:, 3:7] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device)
        q[:, self.dof_q_idx] = dof_pos
        qd = torch.zeros(n, self.model.nv, device=self.device)
        qd[:, self.dof_idx] = dof_vel
        commands = self.cmd_lo + (self.cmd_hi - self.cmd_lo) * u(n, 3)
        return q, qd, commands

    # ---- control: PD position targets -----------------------------------
    def compute_force(self, actions, q, qd, task):
        n = actions.shape[0]
        q_target = torch.zeros(n, self.model.nq, device=actions.device)
        q_target[:, self.dof_q_idx] = self.action_scale * actions + self.default_dof_pos
        return (torch.zeros(n, self.model.nv, device=actions.device),
                torch.zeros(n, self.model.nbody, 6, device=actions.device), q_target)

    def _pd_torques(self, q, qd, actions):
        targets = self.action_scale * actions + self.default_dof_pos
        return self.kp * (targets - q[:, self.dof_q_idx]) - self.kd * qd[:, self.dof_idx]

    def _base_frame(self, q, qd):
        """Base linear and angular velocity and gravity's direction, in the base frame."""
        quat = q[:, 3:7]
        return (maths.quat_rotate_inverse(quat, qd[:, 0:3]), maths.quat_rotate_inverse(quat, qd[:, 3:6]),
                maths.quat_rotate_inverse(quat, self.down.expand(q.shape[0], 3)))

    # ---- observations ---------------------------------------------------
    def observe(self, q, qd, kin, sensors, task, actions, progress):
        lin, ang, grav = self._base_frame(q, qd)
        return torch.cat([
            lin * self.lin_vel_scale,
            ang * self.ang_vel_scale,
            grav,
            task * self.cmd_scale,
            (q[:, self.dof_q_idx] - self.default_dof_pos) * self.dof_pos_scale,
            qd[:, self.dof_idx] * self.dof_vel_scale,
            actions,
        ], dim=-1)

    # ---- reward ---------------------------------------------------------
    def _tracking(self, commands, lin, ang):
        lin_err = torch.sum(torch.square(commands[:, :2] - lin[:, :2]), dim=-1)
        ang_err = torch.square(commands[:, 2] - ang[:, 2])
        return (torch.exp(-lin_err / 0.25) * self.rew_lin_vel_xy_scale,
                torch.exp(-ang_err / 0.25) * self.rew_ang_vel_z_scale)

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        lin, ang, _ = self._base_frame(q, qd)
        r_lin, r_ang = self._tracking(task, lin, ang)
        r_torque = torch.sum(torch.square(self._pd_torques(q, qd, actions)), dim=-1) * self.rew_torque_scale
        total = torch.clamp(r_lin + r_ang + r_torque, min=0.0)
        # termination: base or knee ground contact force > 1 N
        base_hit = torch.linalg.vector_norm(sensors.body_force[:, self.base_body], dim=-1) > 1.0
        knee_hit = torch.any(torch.linalg.vector_norm(sensors.body_force[:, self.knee_bodies], dim=-1) > 1.0, dim=-1)
        done = base_hit | knee_hit | (progress >= self.max_episode_length - 1)
        return total, done, task

    def true_objective(self, q, qd):
        return qd[:, 0]
