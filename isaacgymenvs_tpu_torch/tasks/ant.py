"""Ant locomotion (port of isaacgymenvs_tpu/tasks/ant.py).

Observation, reward, termination and reset sampling copy the JAX task,
batched over envs.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import maths
from ..envcore.vec_task import VecTask
from ..model import load_mjcf
from ..utils.assets import asset_path


class Ant(VecTask):
    uses_kin = False

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self.power_scale = float(env.get("powerScale", 1.0))
        self.dof_vel_scale = float(env.get("dofVelocityScale", 0.2))
        self.contact_force_scale = float(env.get("contactForceScale", 0.1))
        self.heading_weight = float(env.get("headingWeight", 0.5))
        self.up_weight = float(env.get("upWeight", 0.1))
        self.actions_cost_scale = float(env.get("actionsCost", 0.005))
        self.energy_cost_scale = float(env.get("energyCost", 0.05))
        self.joints_at_limit_cost_scale = float(env.get("jointsAtLimitCost", 0.1))
        self.death_cost = float(env.get("deathCost", -2.0))
        self.termination_height = float(env.get("terminationHeight", 0.31))
        self.start_height = 0.44
        env.setdefault("episodeLength", 1000)
        self.num_obs = 60
        self.num_acts = 8
        super().__init__(cfg, device)
        m, dev = self.model, self.device
        dof = self.scalar_dof_indices  # 8 hinge dofs
        sq = np.asarray([m.q_adr[m.dof_body[d]] for d in dof])
        lo = np.asarray(m.dof_limit_lower)[dof]
        hi = np.asarray(m.dof_limit_upper)[dof]
        # initial dof pos: 0 unless the limit range excludes 0
        init = np.where(lo > 0.0, lo, np.where(hi < 0.0, hi, 0.0))
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.dof_idx = long(dof)
        self.dof_q_idx = long(sq)
        self.dof_lower = f32(lo)
        self.dof_upper = f32(hi)
        self.initial_dof_pos = f32(init)
        self.feet = long([i for i, n in enumerate(m.body_names) if "foot" in n])
        self.targets = f32([1000.0, 0.0, 0.0])
        self.qpos0 = f32(m.qpos0)
        self.up_axis = f32([0.0, 0.0, 1.0])
        self.fwd_axis = f32([1.0, 0.0, 0.0])

    def build_model(self):
        asset = self.cfg["env"].get("asset", {}).get("assetFileName", "mjcf/nv_ant.xml")
        return load_mjcf(asset_path(asset)), self.sim_params_from_cfg()

    # ---- init / reset ---------------------------------------------------
    def _potential(self, pos):
        to_target = self.targets - pos
        to_target[:, 2] = 0.0
        # sqrt of the sum of squares, as jnp.linalg.norm computes it
        return -torch.sqrt(torch.sum(to_target * to_target, dim=-1)) / self.dt

    def sample_init(self, generator, n):
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(
            n, 8, generator=generator, device=self.device
        )
        dof_pos = torch.clamp(self.initial_dof_pos + u(-0.2, 0.2), self.dof_lower, self.dof_upper)
        dof_vel = u(-0.1, 0.1)
        q = self.qpos0.repeat(n, 1)
        q[:, 2] = self.start_height
        q[:, self.dof_q_idx] = dof_pos
        qd = torch.zeros(n, self.model.nv, device=self.device)
        qd[:, self.dof_idx] = dof_vel
        pos = q[:, :3].clone()
        pos[:, 2] = 0.0
        potential = self._potential(pos)
        # task state: (potentials, prev_potentials)
        return q, qd, (potential, potential.clone())

    # ---- control --------------------------------------------------------
    def compute_force(self, actions, q, qd, task):
        qfrc = self.qfrc_from_actuators(actions * self.power_scale)
        return qfrc, torch.zeros(actions.shape[0], self.model.nbody, 6, device=actions.device)

    # ---- observations ---------------------------------------------------
    def observe(self, q, qd, kin, sensors, task, actions, progress):
        n = q.shape[0]
        torso_pos = q[:, 0:3]
        torso_rot = q[:, 3:7]
        velocity = qd[:, 0:3]
        ang_velocity = qd[:, 3:6]

        to_target = self.targets - torso_pos
        to_target[:, 2] = 0.0

        up_proj = maths.quat_rotate(torso_rot, self.up_axis)[:, 2]
        heading_vec = maths.quat_rotate(torso_rot, self.fwd_axis)
        heading_proj = torch.sum(heading_vec * maths.normalize(to_target), dim=-1)

        vel_loc = maths.quat_rotate_inverse(torso_rot, velocity)
        angvel_loc = maths.quat_rotate_inverse(torso_rot, ang_velocity)
        roll, _, yaw = maths.get_euler_xyz(torso_rot)
        walk_target_angle = torch.atan2(
            self.targets[2] - torso_pos[:, 2], self.targets[0] - torso_pos[:, 0]
        )
        angle_to_target = walk_target_angle - yaw

        dof_pos = q[:, self.dof_q_idx]
        dof_vel = qd[:, self.dof_idx]
        dof_pos_scaled = maths.unscale(dof_pos, self.dof_lower, self.dof_upper)

        # foot force sensors: 6D wrench per foot (force, torque)
        sensor = torch.cat(
            [sensors.body_force[:, self.feet], sensors.body_torque[:, self.feet]], dim=-1
        ).reshape(n, -1)

        return torch.cat(
            [
                torso_pos[:, 2:3],
                vel_loc,
                angvel_loc,
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
        electricity_cost = torch.sum(torch.abs(actions * obs[:, 20:28]), dim=-1)
        dof_at_limit_cost = torch.sum((obs[:, 12:20] > 0.99).to(obs.dtype), dim=-1)

        alive_reward = 0.5
        progress_reward = potentials - prev_potentials

        total = (
            progress_reward
            + alive_reward
            + up_reward
            + heading_reward
            - self.actions_cost_scale * actions_cost
            - self.energy_cost_scale * electricity_cost
            - dof_at_limit_cost * self.joints_at_limit_cost_scale
        )
        fallen = obs[:, 0] < self.termination_height
        total = torch.where(fallen, torch.full_like(total, self.death_cost), total)
        done = fallen | (progress >= self.max_episode_length - 1)
        # task state advances: potentials roll forward
        return total, done, (potentials, potentials)

    def true_objective(self, q, qd):
        """Forward velocity (the PBT objective)."""
        return qd[:, 0]
