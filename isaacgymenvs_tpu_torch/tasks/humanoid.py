"""Humanoid locomotion, 21 dofs (port of isaacgymenvs_tpu/tasks/humanoid.py).

Observation, reward, termination and reset sampling copy the JAX task,
batched over envs: the 108-dim observation (torso height, local linear
and scaled angular velocity, yaw, roll, angle to the target, up and
heading projections, scaled dof positions and velocities, dof forces, the
6-D wrench of both feet, the actions), the start height 1.34, the
joint-limit cost graded past 0.98 of the range and weighted by each dof's
motor effort over the largest, and potentials -|to_target| / dt.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import maths
from ..envcore.vec_task import VecTask
from ..model import load_mjcf
from ..utils.assets import asset_path


class Humanoid(VecTask):
    uses_kin = False

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self.power_scale = float(env.get("powerScale", 1.0))
        self.dof_vel_scale = float(env.get("dofVelocityScale", 0.1))
        self.angular_velocity_scale = float(env.get("angularVelocityScale", 0.25))
        self.contact_force_scale = float(env.get("contactForceScale", 0.01))
        self.heading_weight = float(env.get("headingWeight", 0.5))
        self.up_weight = float(env.get("upWeight", 0.1))
        self.actions_cost_scale = float(env.get("actionsCost", 0.01))
        self.energy_cost_scale = float(env.get("energyCost", 0.05))
        self.joints_at_limit_cost_scale = float(env.get("jointsAtLimitCost", 0.25))
        self.death_cost = float(env.get("deathCost", -1.0))
        self.termination_height = float(env.get("terminationHeight", 0.8))
        self.start_height = 1.34
        env.setdefault("episodeLength", 1000)
        self.num_obs = 108
        self.num_acts = 21
        super().__init__(cfg, device)
        m, dev = self.model, self.device
        dof = self.scalar_dof_indices
        if len(dof) != 21:
            raise ValueError(f"the Humanoid model has {len(dof)} scalar dofs, the task needs 21")
        sq = np.asarray([m.q_adr[m.dof_body[d]] for d in dof])
        lo = np.asarray(m.dof_limit_lower)[dof]
        hi = np.asarray(m.dof_limit_upper)[dof]
        init = np.where(lo > 0.0, lo, np.where(hi < 0.0, hi, 0.0))
        # per scalar dof, the motor effort (gear) over the largest; 0 where unactuated
        gear = np.zeros(m.nv, np.float32)
        gear[np.asarray(m.actuator_dof)] = np.asarray(m.gear)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.dof_idx = long(dof)
        self.dof_q_idx = long(sq)
        self.dof_lower = f32(lo)
        self.dof_upper = f32(hi)
        self.initial_dof_pos = f32(init)
        self.motor_efforts = f32(gear[dof])
        self.max_motor_effort = float(np.max(np.asarray(m.gear)))
        # the foot bodies by name; the massless links of multi-joint bodies ("__f") are not feet
        feet = [i for i, n in enumerate(m.body_names) if "foot" in n and "__f" not in n]
        if len(feet) != 2:
            raise ValueError(f"the Humanoid model has {len(feet)} foot bodies, the task needs 2")
        self.feet = long(feet)
        self.targets = f32([1000.0, 0.0, 0.0])
        self.qpos0 = f32(m.qpos0)
        self.up_axis = f32([0.0, 0.0, 1.0])
        self.fwd_axis = f32([1.0, 0.0, 0.0])

    def build_model(self):
        asset = self.cfg["env"].get("asset", {}).get("assetFileName", "mjcf/nv_humanoid.xml")
        return load_mjcf(asset_path(asset)), self.sim_params_from_cfg()

    # ---- init / reset ---------------------------------------------------
    def _potential(self, pos):
        to_target = self.targets - pos
        to_target[:, 2] = 0.0
        return -torch.sqrt(torch.sum(to_target * to_target, dim=-1)) / self.dt

    def sample_init(self, generator, n):
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, 21, generator=generator, device=self.device)
        dof_pos = torch.clamp(self.initial_dof_pos + u(-0.2, 0.2), self.dof_lower, self.dof_upper)
        dof_vel = u(-0.1, 0.1)
        q = self.qpos0.repeat(n, 1)
        q[:, 2] = self.start_height
        q[:, self.dof_q_idx] = dof_pos
        qd = torch.zeros(n, self.model.nv, device=self.device)
        qd[:, self.dof_idx] = dof_vel
        potential = self._potential(q[:, :3].clone())
        # task state: (potentials, prev_potentials)
        return q, qd, (potential, potential.clone())

    def standing_states(self, n: int, seed: int):
        """n states (q, qd) with both feet on the ground, for holding the
        kernel against its plain version: the torso upright at qpos0's
        orientation, each leg joint offset by up to 0.05 rad, the same offset
        on both legs (their axes mirror each other, so the feet stay at one
        height), the arms by up to 0.3 rad, every joint 0.02 rad inside its
        limits, the torso lowered until the lowest foot point is 0-1 mm into
        the ground, velocities up to 0.01. Drawn with numpy from `seed`."""
        from ..engine.dynamics import forward_kinematics

        m, rng = self.model, np.random.RandomState(seed)
        names = list(m.dof_joint_names())
        dof = self.scalar_dof_indices
        q = np.tile(np.asarray(m.qpos0, np.float32), (n, 1))
        sq = self.dof_q_idx.cpu().numpy()
        for j in ("hip_x", "hip_z", "hip_y", "knee", "ankle_y", "ankle_x"):
            off = rng.uniform(-0.05, 0.05, n)
            for side in ("right", "left"):
                q[:, sq[list(dof).index(names.index(f"{side}_{j}"))]] = off
        for k, d in enumerate(dof):
            if "shoulder" in names[d] or "elbow" in names[d]:
                q[:, sq[k]] = rng.uniform(-0.3, 0.3, n)
        # 0.02 rad inside the limits (the knee's upper one lies at 2 degrees)
        lo, hi = np.asarray(m.dof_limit_lower)[dof], np.asarray(m.dof_limit_upper)[dof]
        q[:, sq] = np.clip(q[:, sq], lo + 0.02, hi - 0.02)
        qt = torch.tensor(q)
        kin = forward_kinematics(m, qt, torch.zeros(n, m.nv))
        feet = [i for i, b in enumerate(m.cpoint_body) if b in self.feet.tolist()]
        body = torch.as_tensor(np.asarray(m.cpoint_body)[feet])
        pos = torch.as_tensor(np.asarray(m.cpoint_pos, np.float32)[feet])
        world = kin.x[:, body] + maths.quat_rotate(kin.quat[:, body], pos)
        low = (world[..., 2] - torch.as_tensor(np.asarray(m.cpoint_radius, np.float32)[feet])).amin(dim=1)
        q[:, 2] -= low.numpy() + rng.uniform(0.0, 1e-3, n).astype(np.float32)
        qd = rng.uniform(-0.01, 0.01, (n, m.nv)).astype(np.float32)
        return torch.tensor(q, device=self.device), torch.tensor(qd, device=self.device)

    # ---- control --------------------------------------------------------
    def compute_force(self, actions, q, qd, task):
        qfrc = self.qfrc_from_actuators(actions * self.power_scale)
        return qfrc, torch.zeros(actions.shape[0], self.model.nbody, 6, device=actions.device)

    # ---- observations ---------------------------------------------------
    def observe(self, q, qd, kin, sensors, task, actions, progress):
        n = q.shape[0]
        torso_pos = q[:, 0:3]
        torso_rot = q[:, 3:7]
        to_target = self.targets - torso_pos
        to_target[:, 2] = 0.0

        up_proj = maths.quat_rotate(torso_rot, self.up_axis)[:, 2]
        heading_vec = maths.quat_rotate(torso_rot, self.fwd_axis)
        heading_proj = torch.sum(heading_vec * maths.normalize(to_target), dim=-1)
        vel_loc = maths.quat_rotate_inverse(torso_rot, qd[:, 0:3])
        angvel_loc = maths.quat_rotate_inverse(torso_rot, qd[:, 3:6])
        roll, _, yaw = maths.get_euler_xyz(torso_rot)
        walk_target_angle = torch.atan2(
            self.targets[2] - torso_pos[:, 2], self.targets[0] - torso_pos[:, 0]
        )
        angle_to_target = walk_target_angle - yaw

        dof_pos_scaled = maths.unscale(q[:, self.dof_q_idx], self.dof_lower, self.dof_upper)
        dof_vel = qd[:, self.dof_idx]
        dof_force = sensors.dof_force[:, self.dof_idx]
        # foot force sensors: the 6-D wrench (force, torque) of each foot
        sensor = torch.cat(
            [sensors.body_force[:, self.feet], sensors.body_torque[:, self.feet]], dim=-1
        ).reshape(n, -1)

        return torch.cat(
            [
                torso_pos[:, 2:3],
                vel_loc,
                angvel_loc * self.angular_velocity_scale,
                torch.stack(
                    [
                        maths.normalize_angle(yaw),
                        maths.normalize_angle(roll),
                        maths.normalize_angle(angle_to_target),
                        up_proj,
                        heading_proj,
                    ],
                    dim=-1,
                ),
                dof_pos_scaled,
                dof_vel * self.dof_vel_scale,
                dof_force * self.contact_force_scale,
                sensor * self.contact_force_scale,
                actions,
            ],
            dim=-1,
        )

    # ---- reward ---------------------------------------------------------
    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        _, prev_potentials = task
        potentials = self._potential(q[:, 0:3])

        heading_proj = obs[:, 11]
        up_proj = obs[:, 10]
        heading_reward = torch.where(
            heading_proj > 0.8,
            torch.full_like(heading_proj, self.heading_weight),
            self.heading_weight * heading_proj / 0.8,
        )
        up_reward = torch.where(
            up_proj > 0.93, torch.full_like(up_proj, self.up_weight), torch.zeros_like(up_proj)
        )

        actions_cost = torch.sum(actions**2, dim=-1)
        ratio = self.motor_efforts / self.max_motor_effort
        dof_pos_scaled = obs[:, 12:33]
        scaled_cost = self.joints_at_limit_cost_scale * (torch.abs(dof_pos_scaled) - 0.98) / 0.02
        dof_at_limit_cost = torch.sum(
            (torch.abs(dof_pos_scaled) > 0.98).to(obs.dtype) * scaled_cost * ratio, dim=-1
        )
        electricity_cost = torch.sum(torch.abs(actions * obs[:, 33:54]) * ratio, dim=-1)

        alive_reward = 2.0
        progress_reward = potentials - prev_potentials
        total = (
            progress_reward
            + alive_reward
            + up_reward
            + heading_reward
            - self.actions_cost_scale * actions_cost
            - self.energy_cost_scale * electricity_cost
            - dof_at_limit_cost
        )
        fallen = obs[:, 0] < self.termination_height
        total = torch.where(fallen, torch.full_like(total, self.death_cost), total)
        done = fallen | (progress >= self.max_episode_length - 1)
        return total, done, (potentials, potentials)

    def true_objective(self, q, qd):
        """Forward velocity (the PBT objective)."""
        return qd[:, 0]
