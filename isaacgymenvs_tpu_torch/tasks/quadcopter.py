"""Quadcopter: hover at a fixed target with tiltable rotors (port of
isaacgymenvs_tpu/tasks/quadcopter.py), batched over envs.

The model is procedural: a chassis disc with four arms whose rotors tilt in
pitch and roll under PD position drives (stiffness 1000). Actions integrate
the eight dof targets and the four thrusts, both carried in the task state;
each thrust acts along its rotor's LOCAL z as an external wrench.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import maths
from ..engine import dynamics as _dyn
from ..envcore.vec_task import VecTask
from ..model.spec import (
    FREE,
    GEOM_CYLINDER,
    GEOM_SPHERE,
    HINGE,
    ModelBuilder,
    cylinder_inertia,
    sphere_inertia,
)


def _axis_angle_quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    s = math.sin(angle / 2)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(angle / 2)])


class Quadcopter(VecTask):
    use_pd_targets = True
    uses_kin = False

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        env.setdefault("episodeLength", int(env.get("maxEpisodeLength", 500)))
        self.max_thrust = 2.0
        self.num_obs = 21
        self.num_acts = 12
        super().__init__(cfg, device)
        m, dev = self.model, self.device
        sdofs = self.scalar_dof_indices  # 8 hinge dofs
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.dof_q_idx = torch.as_tensor(
            np.asarray([m.q_adr[m.dof_body[d]] for d in sdofs], np.int64), device=dev)
        self.dof_lower = f32(np.asarray(m.dof_limit_lower)[sdofs])
        self.dof_upper = f32(np.asarray(m.dof_limit_upper)[sdofs])
        self.qpos0 = f32(m.qpos0)
        self.init_lo, self.init_hi = f32([-1.5, -1.5, -0.2]), f32([1.5, 1.5, 1.5])
        self.target = f32([0.0, 0.0, 1.0])
        self.z_axis = f32([0.0, 0.0, 1.0])

    def build_model(self):
        chassis_radius = 0.1
        chassis_thickness = 0.03
        rotor_radius = 0.04
        rotor_thickness = 0.01
        rotor_arm_radius = 0.01

        b = ModelBuilder()
        m_ch, i_ch = cylinder_inertia(50.0, chassis_radius, 0.5 * chassis_thickness)
        chassis = b.add_body(
            parent=-1, name="chassis", pos=(0, 0, 0), quat=(0, 0, 0, 1),
            jnt_type=FREE, mass=m_ch, inertia=i_ch,
        )
        b.qpos0_free[chassis] = (
            np.array([0, 0, 1.0], np.float32),
            np.array([0, 0, 0, 1], np.float32),
        )
        b.add_geom(
            chassis, GEOM_CYLINDER, (0, 0, 0), (0, 0, 0, 1),
            (chassis_radius, 0.5 * chassis_thickness, 0), 1.0,
        )

        m_arm, i_arm = sphere_inertia(200.0, rotor_arm_radius)
        m_rot, i_rot = cylinder_inertia(1000.0, rotor_radius, 0.5 * rotor_thickness)
        deg30 = math.radians(30.0)
        self.rotor_bodies = []
        rotor_angles = [0.25 * math.pi, 0.75 * math.pi, 1.25 * math.pi, 1.75 * math.pi]
        arm_offset = chassis_radius + 0.25 * rotor_arm_radius
        rotor_offset = rotor_radius + 0.25 * rotor_arm_radius
        for i, angle in enumerate(rotor_angles):
            arm_quat = _axis_angle_quat((0, 0, 1), angle)
            arm_pos = np.array(
                [arm_offset * math.cos(angle), arm_offset * math.sin(angle), 0.0]
            )
            arm = b.add_body(
                parent=chassis, name=f"rotor_arm{i}",
                pos=arm_pos, quat=arm_quat,
                jnt_type=HINGE, jnt_axis=(0, 1, 0), jnt_pos=(0, 0, 0),
                joint_name=f"rotor_pitch{i}",
                mass=m_arm, inertia=i_arm,
                limit=(-deg30, deg30),
                stiffness=1000.0, damping=0.0,
            )
            b.add_geom(
                arm, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1),
                (rotor_arm_radius, 0, 0), 1.0,
            )
            rotor = b.add_body(
                parent=arm, name=f"rotor{i}",
                pos=(rotor_offset, 0, 0), quat=(0, 0, 0, 1),
                jnt_type=HINGE, jnt_axis=(1, 0, 0), jnt_pos=(0, 0, 0),
                joint_name=f"rotor_roll{i}",
                mass=m_rot, inertia=i_rot,
                limit=(-deg30, deg30),
                stiffness=1000.0, damping=0.0,
            )
            b.add_geom(
                rotor, GEOM_CYLINDER, (0, 0, 0), (0, 0, 0, 1),
                (rotor_radius, 0.5 * rotor_thickness, 0), 1.0,
            )
            self.rotor_bodies.append(rotor)
        return b.finalize(), self.sim_params_from_cfg()

    def sample_init(self, generator, n):
        u = lambda *shape: torch.rand(*shape, generator=generator, device=self.device)
        q = self.qpos0.repeat(n, 1)
        q[:, 0:3] += self.init_lo + (self.init_hi - self.init_lo) * u(n, 3)
        dof_pos = -0.2 + 0.4 * u(n, 8)
        q[:, self.dof_q_idx] = dof_pos
        qd = torch.zeros(n, self.model.nv, device=self.device)
        # task state: (dof targets (n, 8), thrusts (n, 4)), both integrated
        return q, qd, (dof_pos.clone(), torch.zeros(n, 4, device=self.device))

    def _integrate_targets(self, task, actions):
        targets, thrusts = task
        targets = torch.clamp(
            targets + self.dt * 8.0 * math.pi * actions[:, 0:8], self.dof_lower, self.dof_upper
        )
        thrusts = torch.clamp(thrusts + self.dt * 200.0 * actions[:, 8:12], 0.0, self.max_thrust)
        return targets, thrusts

    def compute_force(self, actions, q, qd, task):
        m, n = self.model, actions.shape[0]
        targets, thrusts = self._integrate_targets(task, actions)
        q_target = torch.zeros(n, m.nq, device=actions.device)
        q_target[:, self.dof_q_idx] = targets
        # thrust along each rotor's local z: the rotor's pose comes from FK
        kin = _dyn.forward_kinematics(m, q, qd)
        xfrc = torch.zeros(n, m.nbody, 6, device=actions.device)
        for i, body in enumerate(self.rotor_bodies):
            f_w = maths.quat_rotate(kin.quat[:, body], self.z_axis) * thrusts[:, i:i + 1]
            xfrc[:, body] = torch.cat([torch.linalg.cross(kin.x[:, body], f_w, dim=-1), f_w], dim=-1)
        return torch.zeros(n, m.nv, device=actions.device), xfrc, q_target

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        return torch.cat(
            [
                (self.target - q[:, 0:3]) / 3.0,
                q[:, 3:7],
                qd[:, 0:3] / 2.0,
                qd[:, 3:6] / math.pi,
                q[:, self.dof_q_idx],
            ],
            dim=-1,
        )

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        root_pos = q[:, 0:3]
        target_dist = torch.sqrt(
            root_pos[:, 0] ** 2 + root_pos[:, 1] ** 2 + (1.0 - root_pos[:, 2]) ** 2
        )
        pos_reward = 1.0 / (1.0 + target_dist * target_dist)
        ups = maths.quat_axis(q[:, 3:7], 2)
        tiltage = torch.abs(1.0 - ups[:, 2])
        up_reward = 1.0 / (1.0 + tiltage * tiltage)
        spinnage = torch.abs(qd[:, 5])
        spinnage_reward = 1.0 / (1.0 + spinnage * spinnage)
        reward = pos_reward + pos_reward * (up_reward + spinnage_reward)

        die = (target_dist > 3.0) | (root_pos[:, 2] < 0.3)
        done = die | (progress >= self.max_episode_length - 1)
        return reward, done, self._integrate_targets(task, actions)
