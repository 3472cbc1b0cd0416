"""ShadowHand: in-hand reorientation of an object to goal orientations
(port of isaacgymenvs_tpu/tasks/shadow_hand.py), batched over envs.

The scene composes the hand (its mount fixed at z = 0.5, palm up) and a
free object (`objectType`: block, egg or pen). The goal is task state only.
Contact rows are pair rows only: every hand candidate point against the
object's first geom (`plane_contacts=False`; the episode ends on a fall
before anything reaches the ground), under the cfg's top-K cap. The 20
actions drive the actuated joints' position targets (`q_target`, the
MJCF's <position> kp as stiffness): scaled to the joint range and smoothed
by `actionsMovingAverage`, or relative (`useRelativeControl`); the fixed
tendons *J1c couple each finger's distal joints (stiffness 30, damping
0.1). With `forceScale` > 0 a random force on the object, carried in the
task state, decays every step and is renewed at random (`forceProbRange`).

Observations: `openai` (42), `full_no_vel` / `no_vel` (77), `full` (157)
or `full_state` (211); the asymmetric critic takes `full_state`. The reward
(distance, rotation, action penalty, the goal bonus and the fall penalty)
counts consecutive successes; a success (held `num_success_hold_steps`
steps past the first) draws a new goal orientation without resetting the
episode. `maxConsecutiveSuccesses` > 0 ends the episode there, and then the
episode length counts from the last step within tolerance, for the done
test only. `resetTime` > 0 overrides `episodeLength`. The per-step reward
terms go out as `episode_cumulative`.

The JAX task keeps a PRNG key in its task state for the goal draws and the
force kicks; the port draws them from the env state's generator in
`draws_of_step` (a declared difference: the streams differ; tests hand the
port JAX's draws).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import maths
from ..envcore.vec_task import VecTask
from ..model import load_mjcf, load_urdf
from ..model.compose import compose
from ..utils.assets import asset_path

REW_TERMS = ("dist_rew", "rot_rew", "action_penalty", "reach_goal_rew", "fall_rew", "timeout_rew")


class ShadowHand(VecTask):
    use_pd_targets = True
    # steps the goal must stay within tolerance past the first before it
    # counts as reached (0: at once)
    num_success_hold_steps = 0
    fingertip_names = ("robot0:ffdistal", "robot0:mfdistal", "robot0:rfdistal", "robot0:lfdistal",
                       "robot0:thdistal")
    OBS_DIMS = {"openai": 42, "no_vel": 77, "full_no_vel": 77, "full": 157, "full_state": 211}
    STATE_DIM = 211

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self.dist_reward_scale = float(env.get("distRewardScale", -10.0))
        self.rot_reward_scale = float(env.get("rotRewardScale", 1.0))
        self.action_penalty_scale = float(env.get("actionPenaltyScale", -0.0002))
        self.success_tolerance = float(env.get("successTolerance", 0.1))
        self.reach_goal_bonus = float(env.get("reachGoalBonus", 250.0))
        self.fall_dist = float(env.get("fallDistance", 0.24))
        self.fall_penalty = float(env.get("fallPenalty", 0.0))
        self.rot_eps = float(env.get("rotEps", 0.1))
        self.vel_obs_scale = 0.2
        self.force_torque_obs_scale = 10.0
        self.reset_position_noise = float(env.get("resetPositionNoise", 0.01))
        self.reset_dof_pos_noise = float(env.get("resetDofPosRandomInterval", 0.2))
        self.reset_dof_vel_noise = float(env.get("resetDofVelRandomInterval", 0.0))
        self.force_scale = float(env.get("forceScale", 0.0))
        self.force_prob_range = tuple(env.get("forceProbRange", [0.001, 0.1]))
        self.force_decay = float(env.get("forceDecay", 0.99))
        self.force_decay_interval = float(env.get("forceDecayInterval", 0.08))
        self.dof_speed_scale = float(env.get("dofSpeedScale", 20.0))
        self.use_relative_control = bool(env.get("useRelativeControl", False))
        self.use_capped_dof_control = bool(env.get("use_capped_dof_control", False))
        self.max_dof_radians_per_second = float(env.get("max_dof_radians_per_second", 2.0 * np.pi))
        self.act_moving_average = float(env.get("actionsMovingAverage", 1.0))
        self.max_consecutive_successes = int(env.get("maxConsecutiveSuccesses", 0))
        # resetTime (seconds) > 0 overrides episodeLength: round(t / (controlFrequencyInv dt))
        reset_time = float(env.get("resetTime", -1.0))
        if reset_time > 0.0:
            dt = float(cfg.get("sim", {}).get("dt", 1.0 / 60.0))
            env["episodeLength"] = int(round(reset_time / (int(env.get("controlFrequencyInv", 1)) * dt)))
        self.object_type = str(env.get("objectType", "block"))
        self.ignore_z = self.object_type == "pen"
        self.obs_type = str(env.get("observationType", "full_state"))
        self.asymmetric_obs = bool(env.get("asymmetric_observations", False))
        self.num_obs = self.OBS_DIMS[self.obs_type]
        self.num_states = self.STATE_DIM if self.asymmetric_obs else 0
        self.num_acts = 20
        env.setdefault("episodeLength", 600)
        super().__init__(cfg, device)
        self._setup_indices()
        self._rng = None  # the generator of the state being stepped (`step`)

    def dr_actor_ranges(self):
        return getattr(self, "_actor_ranges", None)

    def build_model(self):
        hand = load_mjcf(asset_path("mjcf/open_ai_assets/hand/shadow_hand.xml"))
        # the coupling tendons' springs
        j1c = np.asarray([n.endswith("J1c") for n in hand.tendon_names])
        hand = hand.replace(tendon_stiffness=np.where(j1c, 30.0, 0.0).astype(np.float32),
                            tendon_damping=np.where(j1c, 0.1, 0.0).astype(np.float32))
        # the position servos' damping (kp came from the <position> actuators)
        hand = hand.replace(dof_damping=np.maximum(np.asarray(hand.dof_damping), 0.1).astype(np.float32))
        obj_file = {"block": "urdf/objects/cube_multicolor.urdf", "egg": "mjcf/open_ai_assets/hand/egg.xml",
                    "pen": "mjcf/open_ai_assets/hand/pen.xml"}[self.object_type]
        obj = load_urdf(asset_path(obj_file)) if obj_file.endswith(".urdf") else load_mjcf(asset_path(obj_file))
        return self._hand_scene(hand, obj, (0.0, 0.0, 0.5), None)

    def _hand_scene(self, hand, obj, base_pos, base_quat):
        """The hand and the object composed, the hand's base at `base_pos`
        (turned by `base_quat` where given), pair rows of every hand
        candidate against the object's first geom and no plane rows."""
        model, refs = compose([hand, obj], ["", "object:"])
        self.hand_ref, self.obj_ref = refs
        self._actor_ranges = {"hand": (0, self.obj_ref.body0),
                              "object": (self.obj_ref.body0, self.obj_ref.body0 + obj.nbody)}
        body_pos = np.asarray(model.body_pos).copy()
        body_pos[0] = base_pos
        model = model.replace(body_pos=body_pos)
        if base_quat is not None:
            body_quat = np.asarray(model.body_quat).copy()
            body_quat[0] = base_quat
            model = model.replace(body_quat=body_quat.astype(np.float32))
        hand_pts = tuple(c for c in range(model.ncp) if model.cpoint_body[c] < self.obj_ref.body0)
        obj_geom = next(g for g in range(model.ngeom) if model.geom_body[g] >= self.obj_ref.body0)
        model = model.replace(ppair_point=hand_pts, ppair_geom=tuple(obj_geom for _ in hand_pts),
                              plane_contacts=False)
        return model, self.sim_params_from_cfg()

    def _setup_indices(self):
        m, dev = self.model, self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        sdofs = list(self.scalar_dof_indices)
        self.num_hand_dofs = len(sdofs)
        self.hand_v_idx = long(sdofs)
        self.hand_q_idx = long([m.q_adr[m.dof_body[d]] for d in sdofs])
        self.dof_lower = f32(np.asarray(m.dof_limit_lower)[sdofs])
        self.dof_upper = f32(np.asarray(m.dof_limit_upper)[sdofs])
        self.actuated_idx = long([sdofs.index(d) for d in m.actuator_dof])
        self.default_dof_pos = torch.zeros(self.num_hand_dofs, device=dev)
        self.obj_q = m.q_adr[self.obj_ref.body0]
        self.obj_v = m.v_adr[self.obj_ref.body0]
        self.obj_body = self.obj_ref.body0
        self.fingertip_bodies = long([m.body_names.index(t) for t in self.fingertip_names])
        self.object_start_pos = f32([0.0, -0.39, 0.52 if self.object_type == "pen" else 0.6])
        self.goal_start_pos = self.object_start_pos + f32([0.0, 0.0, -0.04])
        self.object_mass = float(np.asarray(m.body_mass)[self.obj_body])
        self._qpos0 = f32(m.qpos0)
        self._x_unit, self._y_unit = f32([1.0, 0.0, 0.0]), f32([0.0, 1.0, 0.0])

    # ---- draws ------------------------------------------------------------
    def _rotation(self, u):
        """Rotations (n, 4) from draws u (n, 2) uniform in [-1, 1): the
        reference's two-angle randomize_rotation."""
        n = u.shape[0]
        return maths.quat_mul(maths.quat_from_angle_axis(u[:, 0] * np.pi, self._x_unit.expand(n, 3)),
                              maths.quat_from_angle_axis(u[:, 1] * np.pi, self._y_unit.expand(n, 3)))

    def init_from_draws(self, dof_u, vel_u, pos_u, rot_u, goal_u, prob_u):
        """Init states (q, qd, task) from the draws of a reset: dof_u and
        vel_u (n, hand dofs), pos_u (n, 3), rot_u and goal_u (n, 2), all
        uniform in [-1, 1); prob_u (n,) uniform in [0, 1)."""
        n, m, dev = dof_u.shape[0], self.model, self.device
        delta_max = self.dof_upper - self.default_dof_pos
        delta_min = self.dof_lower - self.default_dof_pos
        rand_delta = delta_min + (delta_max - delta_min) * 0.5 * (dof_u + 1.0)
        dof_pos = self.default_dof_pos + self.reset_dof_pos_noise * rand_delta
        q = self._qpos0.repeat(n, 1)
        q[:, self.hand_q_idx] = dof_pos
        qd = torch.zeros(n, m.nv, device=dev)
        qd[:, self.hand_v_idx] = self.reset_dof_vel_noise * vel_u
        oq = self.obj_q
        q[:, oq:oq + 3] = self.object_start_pos + self.reset_position_noise * pos_u
        q[:, oq + 3:oq + 7] = self._rotation(rot_u)
        lo, hi = self.force_prob_range
        force_prob = torch.exp((np.log(lo) - np.log(hi)) * prob_u + np.log(hi))
        z = torch.zeros(n, device=dev)
        task = {"goal_rot": self._rotation(goal_u), "successes": z, "hold": torch.zeros(n, dtype=torch.int32,
                                                                                        device=dev),
                "targets": dof_pos, "rb_force": torch.zeros(n, 3, device=dev), "force_prob": force_prob,
                "rew_terms": {k: z.clone() for k in REW_TERMS}}
        return q, qd, task

    def sample_init(self, generator, n):
        u = lambda *shape: torch.rand(*shape, generator=generator, device=self.device) * 2 - 1
        nh = self.num_hand_dofs
        return self.init_from_draws(u(n, nh), u(n, nh), u(n, 3), u(n, 2), u(n, 2),
                                    torch.rand(n, generator=generator, device=self.device))

    def draws_of_step(self, n):
        """The draws of one step's reward: the new goals' (n, 2) uniform in
        [-1, 1), the kicks' (n,) uniform in [0, 1) and the kick forces' (n,
        3) standard normal, from the stepped state's generator."""
        g, dev = self._rng, self.device
        return (torch.rand(n, 2, generator=g, device=dev) * 2 - 1, torch.rand(n, generator=g, device=dev),
                torch.randn(n, 3, generator=g, device=dev))

    def step(self, state, actions):
        self._rng = state.rng
        return super().step(state, actions)

    # ---- control --------------------------------------------------------
    def _act_ma(self, task):
        """The targets' moving-average coefficient."""
        return self.act_moving_average

    def _targets(self, prev, actions, task, capped: bool):
        """The joint targets (n, hand dofs) after `actions`, from the last
        targets `prev`: relative, capped (`capped` and
        use_capped_dof_control) or the moving average of the scaled
        actions, each clipped to the joint range."""
        idx = self.actuated_idx
        lo, hi, last = self.dof_lower[idx], self.dof_upper[idx], prev[:, idx]
        if self.use_relative_control:
            cur = torch.clamp(last + self.dof_speed_scale * self.dt * actions, lo, hi)
        elif capped and self.use_capped_dof_control:
            max_d = self.max_dof_radians_per_second * self.dt * self.control_freq_inv
            delta = torch.clamp(maths.scale(actions, lo, hi) - last, -max_d, max_d)
            cur = torch.clamp(last + delta, lo, hi)
        else:
            av = self._act_ma(task)
            cur = torch.clamp(av * maths.scale(actions, lo, hi) + (1.0 - av) * last, lo, hi)
        full = prev.clone()
        full[:, idx] = cur
        return full

    def compute_force(self, actions, q, qd, task):
        n, m = q.shape[0], self.model
        q_target = q.new_zeros(n, m.nq)
        q_target[:, self.hand_q_idx] = self._targets(task["targets"], actions, task, capped=False)
        xfrc = q.new_zeros(n, m.nbody, 6)
        if self.force_scale > 0.0:
            oq = self.obj_q
            f_w = maths.quat_rotate(q[:, oq + 3:oq + 7], task["rb_force"])
            xfrc[:, self.obj_body] = torch.cat([torch.linalg.cross(q[:, oq:oq + 3], f_w, dim=-1), f_w], -1)
        return q.new_zeros(n, m.nv), xfrc, q_target

    # ---- observations ---------------------------------------------------
    def _object_state(self, q, qd):
        oq, ov = self.obj_q, self.obj_v
        return q[:, oq:oq + 3], q[:, oq + 3:oq + 7], qd[:, ov:ov + 3], qd[:, ov + 3:ov + 6]

    def _fingertip_state(self, kin):
        """(n, tips, 13): position, orientation, linear velocity at the
        body's origin, angular velocity."""
        idx = self.fingertip_bodies
        pos, w = kin.x[:, idx], kin.v[:, idx, :3]
        return torch.cat([pos, kin.quat[:, idx], kin.v[:, idx, 3:] + torch.linalg.cross(w, pos, dim=-1), w], -1)

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        return self._obs_impl(q, qd, kin, sensors, task, actions, self.obs_type)

    def observe_state(self, q, qd, kin, sensors, task, actions, progress):
        return self._obs_impl(q, qd, kin, sensors, task, actions, "full_state")

    def _obs_impl(self, q, qd, kin, sensors, task, actions, obs_type):
        n = q.shape[0]
        obj_pos, obj_rot, obj_linvel, obj_angvel = self._object_state(q, qd)
        goal_rot = task["goal_rot"]
        goal_pos = self.goal_start_pos.expand(n, 3)
        quat_diff = maths.quat_mul(obj_rot, maths.quat_conjugate(goal_rot))
        ft = self._fingertip_state(kin)
        scaled_pos = maths.unscale(q[:, self.hand_q_idx], self.dof_lower, self.dof_upper)
        if obs_type == "openai":
            return torch.cat([ft[..., 0:3].reshape(n, -1), obj_pos, quat_diff, actions], -1)
        if obs_type in ("full_no_vel", "no_vel"):
            return torch.cat([scaled_pos, obj_pos, obj_rot, goal_pos, goal_rot, quat_diff,
                              ft[..., 0:3].reshape(n, -1), actions], -1)
        dof_vel = self.vel_obs_scale * qd[:, self.hand_v_idx]
        obj = [obj_pos, obj_rot, obj_linvel, self.vel_obs_scale * obj_angvel, goal_pos, goal_rot, quat_diff]
        if obs_type == "full":
            return torch.cat([scaled_pos, dof_vel, *obj, ft.reshape(n, -1), actions], -1)
        tips = self.fingertip_bodies
        wrench = torch.cat([sensors.body_force[:, tips], sensors.body_torque[:, tips]], -1).reshape(n, -1)
        return torch.cat([scaled_pos, dof_vel, self.force_torque_obs_scale * sensors.dof_force[:, self.hand_v_idx],
                          *obj, ft.reshape(n, -1), self.force_torque_obs_scale * wrench, actions], -1)

    # ---- reward ---------------------------------------------------------
    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        n = q.shape[0]
        obj_pos, obj_rot, _, _ = self._object_state(q, qd)
        goal_rot = task["goal_rot"]
        goal_dist = torch.linalg.vector_norm(obj_pos - self.goal_start_pos, dim=-1)
        tol = 2.0 * self.success_tolerance if self.ignore_z else self.success_tolerance
        quat_diff = maths.quat_mul(obj_rot, maths.quat_conjugate(goal_rot))
        rot_dist = 2.0 * torch.arcsin(torch.clamp(torch.linalg.vector_norm(quat_diff[:, 0:3], dim=-1), max=1.0))

        dist_rew = goal_dist * self.dist_reward_scale
        rot_rew = 1.0 / (torch.abs(rot_dist) + self.rot_eps) * self.rot_reward_scale
        action_penalty = torch.sum(actions ** 2, -1)
        reward = dist_rew + rot_rew + action_penalty * self.action_penalty_scale

        in_tol = torch.abs(rot_dist) <= tol
        hold = torch.where(in_tol, task["hold"] + 1, torch.zeros_like(task["hold"]))
        goal_reached = hold > self.num_success_hold_steps
        successes = task["successes"] + goal_reached
        reward = torch.where(goal_reached, reward + self.reach_goal_bonus, reward)
        fell = goal_dist >= self.fall_dist
        reward = torch.where(fell, reward + self.fall_penalty, reward)

        done = fell
        if self.max_consecutive_successes > 0:
            # the episode length counts from the last step within tolerance, for the done test only
            progress = torch.where(in_tol, torch.zeros_like(progress), progress)
            done = done | (successes >= self.max_consecutive_successes)
        timeout = progress >= self.max_episode_length - 1
        done = done | timeout
        if self.max_consecutive_successes > 0:
            reward = torch.where(timeout, reward + 0.5 * self.fall_penalty, reward)

        goal_u, kick_u, kick_n = self.draws_of_step(n)
        goal_rot = torch.where(goal_reached[:, None], self._rotation(goal_u), goal_rot)
        rb_force = task["rb_force"] * (self.force_decay ** (self.dt / self.force_decay_interval))
        if self.force_scale > 0.0:
            kick = kick_u < task["force_prob"]
            rb_force = torch.where(kick[:, None], kick_n * self.object_mass * self.force_scale, rb_force)
        rew_terms = {
            "dist_rew": dist_rew, "rot_rew": rot_rew, "action_penalty": action_penalty * self.action_penalty_scale,
            "reach_goal_rew": goal_reached * self.reach_goal_bonus, "fall_rew": fell * self.fall_penalty,
            "timeout_rew": (timeout * (0.5 * self.fall_penalty) if self.max_consecutive_successes > 0
                            else torch.zeros_like(dist_rew)),
        }
        new_task = {"goal_rot": goal_rot, "successes": successes,
                    "hold": torch.where(goal_reached, torch.zeros_like(hold), hold),
                    "targets": self._targets(task["targets"], actions, task, capped=True), "rb_force": rb_force,
                    "force_prob": task["force_prob"], "rew_terms": rew_terms}
        return reward, done, new_task

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        """Consecutive successes and the per-step reward terms."""
        return {"consecutive_successes": task["successes"], "episode_cumulative": task["rew_terms"]}

    def true_objective(self, q, qd):
        return q.new_zeros(q.shape[0])

    # ---- comparison states ----------------------------------------------
    def contact_states(self, n: int, seed: int):
        """n states (q, qd) with the object on the hand, for holding the
        kernel against its plain version: the hand's joints at a reset's
        draws (0.2 of the way to a random point of their range); the object
        at a random orientation over the palm (within 2 cm of its start's
        xy), at the height where its geom holds the deepest hand candidate
        below its start 0-0.5 mm in; or (one state in three) lying nearly
        flat (yawed at random, tilted by up to 2 degrees) and pushed 2-4 mm
        in, so that more rows lie in the margin than the cap takes; gentle
        velocities. Drawn with numpy from `seed`."""
        from ..engine.dynamics import forward_kinematics

        m, rng, dev = self.model, np.random.RandomState(seed), self.device
        nh = self.num_hand_dofs
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        q, _, _ = self.init_from_draws(f32(rng.uniform(-1, 1, (n, nh))), torch.zeros(n, nh, device=dev),
                                       torch.zeros(n, 3, device=dev), f32(rng.uniform(-1, 1, (n, 2))),
                                       torch.zeros(n, 2, device=dev), torch.zeros(n, device=dev))
        oq = self.obj_q
        q[:, oq:oq + 2] += f32(rng.uniform(-0.02, 0.02, (n, 2)))
        # one state in three lies nearly flat (yawed, tilted by up to 2 degrees), pushed 2-4 mm in
        pushed = torch.arange(n, device=dev) % 3 == 2
        yaw = f32(rng.uniform(-np.pi, np.pi, n))
        tilt_axis = torch.cat([f32(rng.normal(size=(n, 2))), torch.zeros(n, 1, device=dev)], -1)
        flat = maths.quat_mul(maths.quat_from_angle_axis(yaw, torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3)),
                              maths.quat_from_angle_axis(f32(np.deg2rad(rng.uniform(0.0, 2.0, n))), tilt_axis))
        q[:, oq + 3:oq + 7] = torch.where(pushed[:, None], flat, q[:, oq + 3:oq + 7])
        cb = torch.as_tensor(np.asarray(m.cpoint_body), device=dev)
        pp = torch.as_tensor(np.asarray(m.ppair_point), device=dev)
        kin = forward_kinematics(m, q, torch.zeros(n, m.nv, device=dev))
        cpos = torch.as_tensor(np.asarray(m.cpoint_pos), device=dev)
        pts = (kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], cpos.expand(n, -1, 3)))[:, pp]
        rad = torch.as_tensor(np.asarray(m.cpoint_radius), device=dev)[pp]
        sink = f32(rng.uniform(0.0, 5e-4, n))
        sink = torch.where(pushed, f32(rng.uniform(2e-3, 4e-3, n)), sink)
        # bisect the height at which the deepest candidate below the object's
        # start is `sink` in, from 0.15 m under the start to 0.1 m over it
        below = pts[..., 2] < self.object_start_pos[2]
        lo = self.object_start_pos[2].expand(n) - 0.15
        hi = lo + 0.25
        quat = q[:, oq + 3:oq + 7]
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            pen = rad - self._object_sdf(pts, torch.cat([q[:, oq:oq + 2], mid[:, None]], -1), quat)
            deep = torch.where(below, pen, torch.full_like(pen, -1.0)).amax(1)
            lo, hi = torch.where(deep > sink, mid, lo), torch.where(deep > sink, hi, mid)
        q[:, oq + 2] = 0.5 * (lo + hi)
        qd = f32(rng.uniform(-0.01, 0.01, (n, m.nv)))
        return q, qd

    def _object_sdf(self, pts, centre, quat):
        """(n, P) signed distance of points (n, P, 3) to the object's geom
        at (centre, quat)."""
        from ..model.spec import GEOM_BOX, GEOM_CYLINDER, GEOM_SPHERE

        m = self.model
        g = next(g for g in range(m.ngeom) if m.geom_body[g] >= self.obj_body)
        gt = int(m.geom_type[g])
        size = torch.as_tensor(np.asarray(m.geom_size[g], np.float32), device=pts.device)
        P = pts.shape[1]
        local = maths.quat_rotate_inverse(quat[:, None].expand(-1, P, 4), pts - centre[:, None])
        if gt == GEOM_BOX:
            d = local.abs() - size
            return torch.linalg.vector_norm(torch.clamp(d, min=0.0), dim=-1) + torch.clamp(d.amax(-1), max=0.0)
        if gt == GEOM_SPHERE:
            return torch.linalg.vector_norm(local, dim=-1) - size[0]
        if gt == GEOM_CYLINDER:  # axis along z, radius size[0], half-length size[1]
            d = torch.stack([torch.linalg.vector_norm(local[..., :2], dim=-1) - size[0],
                             local[..., 2].abs() - size[1]], -1)
            return torch.linalg.vector_norm(torch.clamp(d, min=0.0), dim=-1) + torch.clamp(d.amax(-1), max=0.0)
        raise NotImplementedError(f"contact_states for geom type {gt}")
