"""Ingenuity: Mars-helicopter target chasing with direct rotor thrust
(port of isaacgymenvs_tpu/tasks/ingenuity.py), batched over envs.

The model is procedural: a chassis box with two welded rotor discs, under
Mars gravity. Two thrust vectors in the chassis' LOCAL frame act on the
rotor bodies as external wrenches; the target moves every 500 steps.

One declared difference in the task state: the JAX task carries a per-env
PRNG key and folds `progress` into it when the target moves; here
`sample_init` draws every target of the episode at once from the env
generator, as `(targets, window)`, and `reward_done` steps to the next one.
The targets are independent uniform draws in both.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import maths
from ..envcore.vec_task import VecTask
from ..model.spec import FIXED, FREE, GEOM_BOX, GEOM_CYLINDER, ModelBuilder, box_inertia, cylinder_inertia

TARGET_PERIOD = 500  # env steps between target moves


class Ingenuity(VecTask):
    uses_kin = False

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        env.setdefault("episodeLength", int(env.get("maxEpisodeLength", 2000)))
        cfg.setdefault("sim", {}).setdefault("gravity", [0.0, 0.0, -3.721])
        self.thrust_upper_limit = 2000.0
        self.thrust_lateral_component = 0.2
        self.num_obs = 13
        self.num_acts = 6
        super().__init__(cfg, device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self.qpos0 = f32(self.model.qpos0)
        self.rotor_offsets_t = f32(self.rotor_offsets)
        self.init_lo, self.init_hi = f32([-1.5, -1.5, -0.2]), f32([1.5, 1.5, 1.5])
        self.target_lo, self.target_hi = f32([-5.0, -5.0, 1.0]), f32([5.0, 5.0, 2.0])
        # targets an episode can reach: one per started window
        self.num_targets = (self.max_episode_length - 1) // TARGET_PERIOD + 1

    def build_model(self):
        chassis_size = 0.06
        rotor_radius = 0.15
        rotor_thickness = 0.01

        b = ModelBuilder()
        m_ch, i_ch = box_inertia(50.0, (chassis_size, chassis_size, chassis_size))
        chassis = b.add_body(
            parent=-1, name="chassis", pos=(0, 0, 0), quat=(0, 0, 0, 1),
            jnt_type=FREE, mass=m_ch, inertia=i_ch,
        )
        b.qpos0_free[chassis] = (
            np.array([0, 0, 1.0], np.float32),
            np.array([0, 0, 0, 1], np.float32),
        )
        b.add_geom(
            chassis, GEOM_BOX, (0, 0, 0), (0, 0, 0, 1),
            (chassis_size, chassis_size, chassis_size), 1.0,
        )
        m_r, i_r = cylinder_inertia(1000.0, rotor_radius, 0.5 * rotor_thickness)
        self.rotor_bodies = []
        for i in range(2):
            # zero-range hinges in the reference -> welded here
            rotor = b.add_body(
                parent=chassis, name=f"rotor_physics_{i}",
                pos=(0, 0, 0.025 * i), quat=(0, 0, 0, 1),
                jnt_type=FIXED, mass=m_r, inertia=i_r,
            )
            b.add_geom(
                rotor, GEOM_CYLINDER, (0, 0, 0), (0, 0, 0, 1),
                (rotor_radius, 0.5 * rotor_thickness, 0), 1.0,
            )
            self.rotor_bodies.append(rotor)
        self.rotor_offsets = np.array([[0, 0, 0.0], [0, 0, 0.025]], np.float32)
        return b.finalize(), self.sim_params_from_cfg()

    def sample_init(self, generator, n):
        u = lambda *shape: torch.rand(*shape, generator=generator, device=self.device)
        q = self.qpos0.repeat(n, 1)
        q[:, 0:3] += self.init_lo + (self.init_hi - self.init_lo) * u(n, 3)
        qd = torch.zeros(n, self.model.nv, device=self.device)
        targets = self.target_lo + (self.target_hi - self.target_lo) * u(n, self.num_targets, 3)
        # task state: (current target (n, 3), the episode's targets (n, K, 3))
        return q, qd, (targets[:, 0].clone(), targets)

    def compute_force(self, actions, q, qd, task):
        n = actions.shape[0]
        # thrust vectors in the chassis' local frame
        lim, lat = self.thrust_upper_limit, self.thrust_lateral_component
        root_pos, root_quat = q[:, 0:3], q[:, 3:7]
        xfrc = torch.zeros(n, self.model.nbody, 6, device=actions.device)
        for i, body in enumerate(self.rotor_bodies):
            thrust = self.dt * torch.clamp(actions[:, 3 * i + 2] * 2000.0, -lim, lim)
            lateral = torch.clamp(actions[:, 3 * i:3 * i + 2], -lat, lat)
            f_local = torch.cat([thrust[:, None] * lateral, thrust[:, None]], dim=-1)
            f_w = maths.quat_rotate(root_quat, f_local)
            x_b = root_pos + maths.quat_rotate(root_quat, self.rotor_offsets_t[i])
            xfrc[:, body] = torch.cat([torch.linalg.cross(x_b, f_w, dim=-1), f_w], dim=-1)
        return torch.zeros(n, self.model.nv, device=actions.device), xfrc

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        target = task[0]
        return torch.cat(
            [(target - q[:, 0:3]) / 3.0, q[:, 3:7], qd[:, 0:3] / 2.0, qd[:, 3:6] / math.pi], dim=-1
        )

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        target, targets = task
        root_pos = q[:, 0:3]
        d = target - root_pos
        target_dist = torch.sqrt(torch.sum(d * d, dim=-1))
        pos_reward = 1.0 / (1.0 + target_dist * target_dist)
        ups = maths.quat_axis(q[:, 3:7], 2)
        tiltage = torch.abs(1.0 - ups[:, 2])
        up_reward = 5.0 / (1.0 + tiltage * tiltage)
        spinnage = torch.abs(qd[:, 5])
        spinnage_reward = 1.0 / (1.0 + spinnage * spinnage)
        reward = pos_reward + pos_reward * (up_reward + spinnage_reward)

        die = (target_dist > 8.0) | (root_pos[:, 2] < 0.5)
        done = die | (progress >= self.max_episode_length - 1)

        # the target moves every TARGET_PERIOD steps within an episode
        resample = (progress % TARGET_PERIOD == 0) & (progress > 0)
        window = torch.clamp(progress // TARGET_PERIOD, max=self.num_targets - 1).long()
        nxt = targets[torch.arange(targets.shape[0], device=targets.device), window]
        target = torch.where(resample[:, None], nxt, target)
        return reward, done, (target, targets)
