"""BallBalance: keep a ball centred on a tray driven by three legs (port of
isaacgymenvs_tpu/tasks/ball_balance.py), batched over envs.

The model is procedural: a free-floating tray on three two-segment legs
whose feet are pinned to the ground by bilateral point anchors, and a free
ball that meets the tray through a declared point-vs-cylinder pair row. The
lower legs follow velocity-integrated PD position targets carried in the
task state; the observation reads the tray's contact force and its torque
about the three leg mounts.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import maths
from ..envcore.vec_task import VecTask
from ..model.spec import (
    FREE,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_SPHERE,
    HINGE,
    ModelBuilder,
    capsule_inertia,
    cylinder_inertia,
    sphere_inertia,
)


def _euler_zyx_quat(roll, pitch, yaw):
    """Quaternion (xyzw) of the rotation yaw about z, pitch about y, roll about x."""
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ]
    )


class BallBalance(VecTask):
    use_pd_targets = True
    # the one kinematic product `observe` reads is the tray's orientation,
    # and the tray is a free body: its quaternion stands in q
    uses_kin = False

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self.action_speed_scale = float(env.get("actionSpeedScale", 20.0))
        env.setdefault("episodeLength", int(env.get("maxEpisodeLength", 500)))
        self.ball_radius = 0.1
        self.num_obs = 24
        self.num_acts = 3
        super().__init__(cfg, device)
        m, dev = self.model, self.device
        sdofs = self.scalar_dof_indices  # [u0, l0, u1, l1, u2, l2]
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        self.dof_idx = long(sdofs)
        self.dof_q_idx = long([m.q_adr[m.dof_body[d]] for d in sdofs])
        self.dof_lower = f32(np.asarray(m.dof_limit_lower)[sdofs])
        self.dof_upper = f32(np.asarray(m.dof_limit_upper)[sdofs])
        self.actuated = long([1, 3, 5])  # the lower legs
        self.ball_v = m.v_adr[self.ball_body]
        self.tray_q = m.q_adr[self.tray_body]
        self.qpos0 = f32(m.qpos0)
        # tray sensor points at the three leg mounts, tray frame
        self.mounts = f32([
            [self.leg_outer_offset * math.cos(a), self.leg_outer_offset * math.sin(a), 0.0]
            for a in self.leg_angles
        ])

    def build_model(self):
        tray_radius = 0.5
        tray_thickness = 0.02
        leg_radius = 0.02
        leg_outer_offset = tray_radius - 0.1
        leg_length = leg_outer_offset - 2 * leg_radius
        leg_inner_offset = leg_outer_offset - leg_length / math.sqrt(2)
        tray_height = leg_length * math.sqrt(2) + 2 * leg_radius + 0.5 * tray_thickness
        self.tray_height = tray_height
        self.leg_length = leg_length
        self.leg_outer_offset = leg_outer_offset
        self.leg_angles = [0.0, 2.0 / 3.0 * math.pi, 4.0 / 3.0 * math.pi]

        b = ModelBuilder()
        m_tray, i_tray = cylinder_inertia(100.0, tray_radius, 0.5 * tray_thickness)
        tray = b.add_body(
            parent=-1,
            name="tray",
            pos=(0, 0, 0),
            quat=(0, 0, 0, 1),
            jnt_type=FREE,
            mass=m_tray,
            inertia=i_tray,
        )
        b.qpos0_free[tray] = (
            np.array([0, 0, tray_height], np.float32),
            np.array([0, 0, 0, 1], np.float32),
        )
        b.add_geom(
            tray, GEOM_CYLINDER, (0, 0, 0), (0, 0, 0, 1),
            (tray_radius, 0.5 * tray_thickness, 0), 1.0,
        )

        m_leg, i_leg = capsule_inertia(1000.0, leg_radius, 0.5 * leg_length)
        lower_legs = []
        for i, angle in enumerate(self.leg_angles):
            # upper leg: capsule along local z, hinged to the tray
            uf = np.array(
                [
                    leg_outer_offset * math.cos(angle),
                    leg_outer_offset * math.sin(angle),
                    -leg_radius - 0.5 * tray_thickness,
                ]
            )
            ut = np.array(
                [
                    leg_inner_offset * math.cos(angle),
                    leg_inner_offset * math.sin(angle),
                    uf[2] - leg_length / math.sqrt(2),
                ]
            )
            upos = 0.5 * (uf + ut)
            uquat = _euler_zyx_quat(0.0, -0.75 * math.pi, angle)
            upper = b.add_body(
                parent=tray,
                name=f"upper_leg{i}",
                pos=upos,
                quat=uquat,
                jnt_type=HINGE,
                jnt_axis=(0, 1, 0),
                jnt_pos=(0, 0, -0.5 * leg_length),
                joint_name=f"upper_leg_joint{i}",
                mass=m_leg,
                inertia=i_leg,
                limit=(-math.radians(45), math.radians(45)),
            )
            b.add_geom(
                upper, GEOM_CAPSULE, (0, 0, 0), (0, 0, 0, 1),
                (leg_radius, 0.5 * leg_length, 0), 1.0,
            )
            lower = b.add_body(
                parent=upper,
                name=f"lower_leg{i}",
                pos=(-0.5 * leg_length, 0, 0.5 * leg_length),
                quat=_euler_zyx_quat(0.0, -0.5 * math.pi, 0.0),
                jnt_type=HINGE,
                jnt_axis=(0, 1, 0),
                jnt_pos=(0, 0, -0.5 * leg_length),
                joint_name=f"lower_leg_joint{i}",
                mass=m_leg,
                inertia=i_leg,
                limit=(-math.radians(70), math.radians(90)),
                stiffness=4000.0,  # PD drive gains
                damping=100.0,
            )
            b.add_geom(
                lower, GEOM_CAPSULE, (0, 0, 0), (0, 0, 0, 1),
                (leg_radius, 0.5 * leg_length, 0), 1.0,
            )
            lower_legs.append(lower)

        m_ball, i_ball = sphere_inertia(200.0, self.ball_radius)
        ball = b.add_body(
            parent=-1,
            name="ball",
            pos=(0, 0, 0),
            quat=(0, 0, 0, 1),
            jnt_type=FREE,
            mass=m_ball,
            inertia=i_ball,
        )
        b.qpos0_free[ball] = (
            np.array([0.2, 0, 2.0], np.float32),
            np.array([0, 0, 0, 1], np.float32),
        )
        b.add_geom(
            ball, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1),
            (self.ball_radius, 0, 0), 1.0,
        )

        model = b.finalize()
        self.tray_body = tray
        self.ball_body = ball
        self.ball_q = model.q_adr[ball]

        # ball vs tray: the sphere's centre candidate point against the tray
        # cylinder, a point-vs-geom pair row of the fused step
        tray_geom = model.geom_body.index(tray)
        ball_cp = model.cpoint_body.index(ball)
        # foot anchors: bilateral rows pinning the lower-leg tips to the ground
        att_offset = np.tile(np.array([0, 0, 0.5 * leg_length], np.float32), (3, 1))
        att_target = np.stack(
            [
                np.array(
                    [leg_outer_offset * math.cos(a), leg_outer_offset * math.sin(a), leg_radius],
                    np.float32,
                )
                for a in self.leg_angles
            ]
        )
        model = model.replace(
            ppair_point=(ball_cp,),
            ppair_geom=(tray_geom,),
            att_body=tuple(lower_legs),
            att_offset=att_offset,
            att_target=att_target,
        )
        return model, self.sim_params_from_cfg()

    def sample_init(self, generator, n):
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=generator, device=self.device)
        q = self.qpos0.repeat(n, 1)
        qd = torch.zeros(n, self.model.nv, device=self.device)
        # the ball drops from 1-2 m towards the tray centre
        dist = u(0.001, 0.5)
        ang = u(-math.pi, math.pi)
        direc = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        height = u(1.0, 2.0)
        speedscale = (dist - 0.001) / (0.5 - 0.001)
        hspeed = u(0.0, 5.0)
        bq, bv = self.ball_q, self.ball_v
        q[:, bq:bq + 2] = dist[:, None] * direc
        q[:, bq + 2] = height
        qd[:, bv:bv + 2] = -(speedscale * hspeed)[:, None] * direc
        qd[:, bv + 2] = -5.0
        # task state: integrated dof position targets (n, 6)
        return q, qd, torch.zeros(n, 6, device=self.device)

    def _integrate_targets(self, targets, actions):
        """targets += dt * speed_scale * action on the lower legs, clamped to the limits."""
        targets = targets.clone()
        targets[:, self.actuated] += self.dt * self.action_speed_scale * actions
        return torch.clamp(targets, self.dof_lower, self.dof_upper)

    def compute_force(self, actions, q, qd, task):
        m, n = self.model, actions.shape[0]
        q_target = torch.zeros(n, m.nq, device=actions.device)
        q_target[:, self.dof_q_idx] = self._integrate_targets(task, actions)
        zeros = lambda *shape: torch.zeros(*shape, device=actions.device)
        return zeros(n, m.nv), zeros(n, m.nbody, 6), q_target

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        dof_pos = q[:, self.dof_q_idx]
        dof_vel = qd[:, self.dof_idx]
        bq, bv = self.ball_q, self.ball_v
        # tray force sensors at the three leg mounts: one shared force, the
        # torque re-referenced to each mount
        bf = sensors.body_force[:, self.tray_body]
        bt = sensors.body_torque[:, self.tray_body]
        tray_quat = maths.quat_unit(q[:, self.tray_q + 3:self.tray_q + 7])
        torques = [
            bt - torch.linalg.cross(maths.quat_rotate(tray_quat, self.mounts[i]), bf, dim=-1)
            for i in range(3)
        ]
        return torch.cat(
            [
                dof_pos[:, self.actuated],
                dof_vel[:, self.actuated],
                q[:, bq:bq + 3],
                qd[:, bv:bv + 3],
                bf / 20.0,
                torques[0] / 20.0,
                torques[1] / 20.0,
                torques[2] / 20.0,
            ],
            dim=-1,
        )

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        bq, bv = self.ball_q, self.ball_v
        ball_pos = q[:, bq:bq + 3]
        ball_vel = qd[:, bv:bv + 3]
        ball_dist = torch.sqrt(
            ball_pos[:, 0] ** 2 + (ball_pos[:, 2] - 0.7) ** 2 + ball_pos[:, 1] ** 2
        )
        ball_speed = torch.sqrt(torch.sum(ball_vel * ball_vel, dim=-1))
        reward = (1.0 / (1.0 + ball_dist)) * (1.0 / (1.0 + ball_speed))
        done = (progress >= self.max_episode_length - 1) | (ball_pos[:, 2] < self.ball_radius * 1.5)
        # the integrated targets persist, recomputed as compute_force did
        return reward, done, self._integrate_targets(task, actions)
