"""Trifinger: cube repositioning and reorientation with the three-finger
platform (port of isaacgymenvs_tpu/tasks/trifinger.py), batched over envs.

The scene composes the TriFingerPro (its base fixed at the world origin,
the fingers hanging over the table at z = 0) and a free 65 mm cube. Contact
rows: the three fingertips against the cube (pair rows), and plane rows for
the cube's eight corners and the hanging tips (the other candidates are
pruned). `max_active_contacts: 0`: every row enters the solve.

The 41 policy observations follow OBS_SPEC (joint positions, velocities,
the cube's pose, the goal pose, the last command), each component scaled to
[-1, 1] by its bounds when `normalize_obs`; the asymmetric critic's 113
add the cube's velocity, the fingertips' states, the joint contact forces
and the fingertips' contact wrenches. Actions are joint torques (`torque`)
or joint targets of a PD law (`position`), both in [-1, 1] when
`normalize_action`; the torques are saturated at 0.36 Nm, safety-damped and
saturated again (the model's `dof_max_effort` is set and, as in the JAX
package, ignored by the engine: these clips are what bind). The reward is
the keypoint kernel with the fingers' motion and reach terms; the success
flags of position and orientation are reported per step. Goals follow
`task_difficulty` (1-4).

The random streams differ from the JAX package's (`torch.Generator`); the
JAX task also draws the radius and angle of a placement from one key, the
port from two draws.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import maths
from ..envcore.vec_task import VecTask
from ..model import load_urdf
from ..model.compose import compose
from ..utils.assets import asset_path
from .franka_cube_stack import _box_actor, _qmul_np, _qrot_np, _quat_np

OBJ_SIZE = 0.065
MAX_TORQUE = 0.36
MAX_VELOCITY = 10.0  # rad/s
ARENA_RADIUS = 0.195

# PD gains of the finger drives and the safety damping, per finger joint
STIFFNESS = np.tile(np.array([10.0, 10.0, 10.0], np.float32), 3)
DAMPING = np.tile(np.array([0.1, 0.3, 0.001], np.float32), 3)
SAFETY_DAMPING = np.tile(np.array([0.08, 0.08, 0.04], np.float32), 3)
_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)


def gen_keypoints(pos, quat, size=OBJ_SIZE):
    """The cube's 8 corners (N, 8, 3) in the world frame."""
    corners = torch.as_tensor(_CORNERS * size / 2.0, device=pos.device)
    n = pos.shape[0]
    return pos[:, None, :] + maths.quat_rotate(quat[:, None, :].expand(n, 8, 4), corners.expand(n, 8, 3))


class Trifinger(VecTask):
    OBS_SPEC = {"robot_q": 9, "robot_u": 9, "object_q": 7, "object_q_des": 7, "command": 9}
    STATE_EXTRA_SPEC = {"object_u": 6, "fingertip_state": 3 * 13, "robot_a": 9, "fingertip_wrench": 3 * 6}
    ACTION_SPEC = {"command": 9}

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self.task_difficulty = int(env.get("task_difficulty", 4))
        self.asymmetric_obs = bool(env.get("asymmetric_obs", True))
        self.normalize_action = bool(env.get("normalize_action", True))
        self.normalize_obs = bool(env.get("normalize_obs", True))
        self.apply_safety_damping = bool(env.get("apply_safety_damping", True))
        self.command_mode = str(env.get("command_mode", "torque"))
        term = (env.get("termination_conditions") or {}).get("success", {})
        self.position_tolerance = float(term.get("position_tolerance", 0.02))
        self.orientation_tolerance = float(term.get("orientation_tolerance", 0.4))
        rt = env.get("reward_terms", {})
        self.finger_move_penalty_weight = float(rt.get("finger_move_penalty", {}).get("weight", -0.5))
        self.finger_reach_object_weight = float(rt.get("finger_reach_object_rate", {}).get("weight", -250.0))
        # the keypoint kernel's weight: the JAX task scales it by object_dist's
        self.object_dist_weight = float(rt.get("object_dist", {}).get("weight", 2000.0))
        env.setdefault("episodeLength", 750)
        self.num_obs = sum(self.OBS_SPEC.values())
        self.num_states = self.num_obs + sum(self.STATE_EXTRA_SPEC.values()) if self.asymmetric_obs else 0
        self.num_acts = sum(self.ACTION_SPEC.values())
        super().__init__(cfg, device)

        m, dev = self.model, self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        sdofs = self.scalar_dof_indices
        self.q_idx = long([m.q_adr[m.dof_body[d]] for d in sdofs])
        self.v_idx = long(sdofs)
        self.default_dof = f32(np.tile([0.0, 0.9, -2.0], 3))
        self.dof_lower = f32(np.tile([-0.33, 0.0, -2.7], 3))
        self.dof_upper = f32(np.tile([1.0, 1.57, 0.0], 3))
        self.tip_bodies = long([i for i, name in enumerate(m.body_names) if "tip_link" in name])
        self.oq = m.q_adr[self.obj_ref.body0]
        self.ov = m.v_adr[self.obj_ref.body0]
        if self.command_mode == "position":
            self.action_lo, self.action_hi = self.dof_lower, self.dof_upper
        else:
            self.action_lo, self.action_hi = f32(np.full(9, -MAX_TORQUE)), f32(np.full(9, MAX_TORQUE))
        # observation bounds: joint limits, +-10 rad/s, the pose box (xyz) x
        # quaternion +-1 for the cube and the goal, the command
        obj_lo, obj_hi = [-0.3, -0.3, 0.0, -1, -1, -1, -1], [0.3, 0.3, 0.3, 1, 1, 1, 1]
        act_lo = -torch.ones(9, device=dev) if self.normalize_action else self.action_lo
        act_hi = torch.ones(9, device=dev) if self.normalize_action else self.action_hi
        self.obs_lo = torch.cat([self.dof_lower, f32(np.full(9, -MAX_VELOCITY)), f32(obj_lo), f32(obj_lo), act_lo])
        self.obs_hi = torch.cat([self.dof_upper, f32(np.full(9, MAX_VELOCITY)), f32(obj_hi), f32(obj_hi), act_hi])
        self._stiff, self._damp, self._safety = f32(STIFFNESS), f32(DAMPING), f32(SAFETY_DAMPING)
        self._qpos0 = f32(m.qpos0)
        self._x_axis, self._y_axis, self._z_axis = f32([1.0, 0, 0]), f32([0.0, 1, 0]), f32([0.0, 0, 1])
        self._unit_quat = f32([0.0, 0, 0, 1])

    def dr_actor_ranges(self):
        return getattr(self, "_actor_ranges", None)

    def build_model(self):
        robot = load_urdf(asset_path("trifinger/robot_properties_fingers/urdf/pro/trifingerpro.urdf"), fix_base=True)
        # set, and ignored by the engine: compute_force's clips bind
        robot = robot.replace(dof_max_effort=np.full(robot.nv, MAX_TORQUE, np.float32))
        obj = _box_actor("object", [OBJ_SIZE] * 3, 264.0, False, [0.0, 0.0, OBJ_SIZE / 2])
        model, refs = compose([robot, obj], ["", "object:"])
        self.robot_ref, self.obj_ref = refs
        self._actor_ranges = {"robot": (0, self.obj_ref.body0),
                              "object": (self.obj_ref.body0, self.obj_ref.body0 + obj.nbody)}
        body_pos = np.asarray(model.body_pos).copy()
        body_pos[0] = 0.0  # the platform's base at the world origin, the table top at z = 0
        model = model.replace(body_pos=body_pos)
        # pair rows: the tips' candidates against the cube; plane rows: the
        # cube's corners and the tips (the other candidates are pruned)
        tips = [i for i, name in enumerate(model.body_names) if "tip_link" in name]
        tip_pts = [c for c in range(model.ncp) if model.cpoint_body[c] in tips]
        obj_body = self.obj_ref.body0
        keep = sorted({c for c in range(model.ncp) if model.cpoint_body[c] == obj_body} | set(tip_pts))
        remap = {c: i for i, c in enumerate(keep)}
        sel = np.asarray(keep)
        model = model.replace(
            cpoint_body=tuple(model.cpoint_body[c] for c in keep),
            cpoint_pos=np.asarray(model.cpoint_pos)[sel],
            cpoint_radius=np.asarray(model.cpoint_radius)[sel],
            cpoint_friction=np.asarray(model.cpoint_friction)[sel],
            ppair_point=tuple(remap[c] for c in tip_pts),
            ppair_geom=tuple(self.obj_ref.geom0 for _ in tip_pts),
        )
        return model, self.sim_params_from_cfg()

    # ---- goals and init -------------------------------------------------
    def _placement(self, generator, n):
        """(n, 2) xy uniform over the arena's disc."""
        u = lambda: torch.rand(n, generator=generator, device=self.device)
        r = ARENA_RADIUS * torch.sqrt(u())
        th = u() * 2 * np.pi - np.pi
        return torch.stack([r * torch.cos(th), r * torch.sin(th)], -1)

    def goal_from_draws(self, xy, z_u, rot_u):
        """Goal poses (n, 7) of the task's difficulty from the draws: xy on
        the arena (n, 2), z_u (n,) uniform in [0, 1), rot_u (n, 2) uniform
        in [-1, 1)."""
        n, dev = xy.shape[0], self.device
        d = self.task_difficulty
        if d == 1:
            pos = torch.cat([xy, torch.full((n, 1), OBJ_SIZE / 2, device=dev)], -1)
        elif d == 2:
            pos = torch.tensor([0.0, 0.0, OBJ_SIZE / 2 + 0.05], device=dev).expand(n, 3)
        else:
            pos = torch.cat([xy, (OBJ_SIZE + (0.3 - OBJ_SIZE) * z_u)[:, None]], -1)
        if d == 4:
            quat = maths.quat_mul(maths.quat_from_angle_axis(rot_u[:, 0] * np.pi, self._x_axis.expand(n, 3)),
                                  maths.quat_from_angle_axis(rot_u[:, 1] * np.pi, self._y_axis.expand(n, 3)))
        else:
            quat = self._unit_quat.expand(n, 4)
        return torch.cat([pos, quat], -1)

    def sample_init(self, generator, n):
        dev = self.device
        dof = self.default_dof + 0.03 * torch.randn(n, 9, generator=generator, device=dev)
        q = self._qpos0.repeat(n, 1)
        q[:, self.q_idx] = torch.clamp(dof, self.dof_lower, self.dof_upper)
        # the cube: a random yaw pose on the table
        xy = self._placement(generator, n)
        yaw = torch.rand(n, generator=generator, device=dev) * 2 * np.pi - np.pi
        pos = torch.cat([xy, torch.full((n, 1), OBJ_SIZE / 2, device=dev)], -1)
        q[:, self.oq:self.oq + 3] = pos
        q[:, self.oq + 3:self.oq + 7] = maths.quat_from_angle_axis(yaw, self._z_axis.expand(n, 3))
        goal = self.goal_from_draws(self._placement(generator, n), torch.rand(n, generator=generator, device=dev),
                                    torch.rand(n, 2, generator=generator, device=dev) * 2 - 1)
        z = torch.zeros(n, device=dev)
        task = {"goal": goal, "last_tips": torch.zeros(n, 3, 3, device=dev), "last_obj": pos,
                "success": z, "success_pos": z.clone(), "success_rot": z.clone()}
        return q, torch.zeros(n, self.model.nv, device=dev), task

    # ---- control --------------------------------------------------------
    def compute_force(self, actions, q, qd, task):
        """torque mode: the actions are the joint torques; position mode: a
        PD law toward the commanded joint positions; both saturated at
        MAX_TORQUE, then safety-damped and saturated again."""
        m = self.model
        cmd = self.action_lo + (actions + 1.0) * 0.5 * (self.action_hi - self.action_lo) \
            if self.normalize_action else actions
        uj = qd[:, self.v_idx]
        tau = self._stiff * (cmd - q[:, self.q_idx]) - self._damp * uj if self.command_mode == "position" else cmd
        tau = torch.clamp(tau, -MAX_TORQUE, MAX_TORQUE)
        if self.apply_safety_damping:
            tau = torch.clamp(tau - self._safety * uj, -MAX_TORQUE, MAX_TORQUE)
        qfrc = q.new_zeros(q.shape[0], m.nv)
        qfrc[:, self.v_idx] = tau
        return qfrc, q.new_zeros(q.shape[0], m.nbody, 6)

    # ---- observations ---------------------------------------------------
    def obs_spec(self):
        """{key: (offset, size)} of the policy observation, from OBS_SPEC."""
        spec, off = {}, 0
        for name, n in self.OBS_SPEC.items():
            spec[name] = (off, n)
            off += n
        return spec

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        obs = torch.cat([q[:, self.q_idx], qd[:, self.v_idx], q[:, self.oq:self.oq + 7], task["goal"], actions], -1)
        if self.normalize_obs:
            obs = 2.0 * (obs - self.obs_lo) / (self.obs_hi - self.obs_lo) - 1.0
        return obs

    def observe_state(self, q, qd, kin, sensors, task, actions, progress):
        tips, n = self.tip_bodies, q.shape[0]
        v = kin.v[:, tips]
        tip_state = torch.cat([kin.x[:, tips], kin.quat[:, tips],
                               v[..., 3:] + torch.linalg.cross(v[..., :3], kin.x[:, tips], dim=-1), v[..., :3]], -1)
        wrench = torch.cat([sensors.body_force[:, tips], sensors.body_torque[:, tips]], -1)
        return torch.cat([self.observe(q, qd, kin, sensors, task, actions, progress), qd[:, self.ov:self.ov + 6],
                          tip_state.reshape(n, -1), sensors.dof_force[:, self.v_idx], wrench.reshape(n, -1)], -1)

    # ---- reward ---------------------------------------------------------
    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
        obj_pos, obj_quat = q[:, self.oq:self.oq + 3], q[:, self.oq + 3:self.oq + 7]
        goal = task["goal"]
        tips = kin.x[:, self.tip_bodies]
        tip_vel = (tips - task["last_tips"]) / self.dt
        move_pen = self.finger_move_penalty_weight * torch.sum(tip_vel ** 2, dim=(1, 2))
        curr = norm(tips - obj_pos[:, None, :])
        prev = norm(task["last_tips"] - task["last_obj"][:, None, :])
        reach = self.finger_reach_object_weight * torch.sum(curr - prev, -1)
        dist = norm(gen_keypoints(obj_pos, obj_quat) - gen_keypoints(goal[:, :3], goal[:, 3:7]))
        scaled = dist * 30.0
        kernel = 1.0 / (torch.exp(scaled) + 2.0 + torch.exp(-scaled))
        reward = move_pen + reach + self.object_dist_weight * self.dt * kernel.mean(-1)
        done = progress >= self.max_episode_length - 1
        pos_ok = norm(obj_pos - goal[:, :3]) <= self.position_tolerance
        dq = maths.quat_mul(obj_quat, maths.quat_conjugate(goal[:, 3:7]))
        rot_ok = 2.0 * torch.arcsin(torch.clamp(norm(dq[:, :3]), 0.0, 1.0)) <= self.orientation_tolerance
        success = pos_ok & rot_ok if self.task_difficulty == 4 else pos_ok
        return reward, done, {"goal": goal, "last_tips": tips, "last_obj": obj_pos, "success": success.float(),
                              "success_pos": pos_ok.float(), "success_rot": rot_ok.float()}

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        return {"successes": task["success"], "successes_pos": task["success_pos"],
                "successes_quat": task["success_rot"]}

    def true_objective(self, q, qd):
        return -torch.linalg.vector_norm(q[:, self.oq:self.oq + 3], dim=-1)

    def contact_states(self, n: int, seed: int):
        """n states (q, qd) with fingertips on the cube, for holding the
        kernel against its plain version: the joints within 0.15 rad of the
        default pose; the cube on the table, its lowest corner 0-0.5 mm in
        and tilted by up to 2 degrees, yawed so that a face looks at one
        finger's tip (in turn), set against that tip with the tip 0-0.5 mm
        into the face; the other tips where the joints put them; gentle
        velocities. Drawn with numpy from `seed`."""
        from ..engine.dynamics import forward_kinematics

        m, rng, dev = self.model, np.random.RandomState(seed), self.device
        q = np.tile(np.asarray(m.qpos0, np.float64), (n, 1))
        q_idx = self.q_idx.cpu().numpy()
        q[:, q_idx] = self.default_dof.cpu().numpy() + rng.uniform(-0.15, 0.15, (n, 9))
        kin = forward_kinematics(m, torch.tensor(q, dtype=torch.float32), torch.zeros(n, m.nv))
        tips = kin.x[:, self.tip_bodies.cpu()].double().numpy()
        r_tip = float(np.asarray(m.cpoint_radius)[list(m.cpoint_body).index(int(self.tip_bodies[0]))])
        half = OBJ_SIZE / 2
        for i in range(n):
            tip = tips[i, i % 3]
            out = np.array([tip[0], tip[1], 0.0])
            out /= max(np.linalg.norm(out), 1e-6)  # from the arena's axis toward the tip: the cube lies inside it
            yaw = np.arctan2(out[1], out[0])
            axis = np.array([*rng.normal(size=2), 0.0])
            quat = _qmul_np(_quat_np(np.array([0.0, 0.0, 1.0]), yaw),
                            _quat_np(axis / np.linalg.norm(axis), np.deg2rad(rng.uniform(0.0, 2.0))))
            low = min(_qrot_np(quat, c * half)[2] for c in _CORNERS)
            pos = tip - out * (half + r_tip - rng.uniform(0.0, 5e-4))
            pos[2] = -low - rng.uniform(0.0, 5e-4)
            q[i, self.oq:self.oq + 3], q[i, self.oq + 3:self.oq + 7] = pos, quat
        qd = rng.uniform(-0.01, 0.01, (n, m.nv))
        return torch.tensor(q, dtype=torch.float32, device=dev), torch.tensor(qd, dtype=torch.float32, device=dev)
