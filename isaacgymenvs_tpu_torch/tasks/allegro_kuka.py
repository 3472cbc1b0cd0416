"""AllegroKuka: a KUKA iiwa arm with an Allegro hand lifts a cube off a
table and brings it to a goal pose (port of
isaacgymenvs_tpu/tasks/allegro_kuka.py), batched over envs. Three
subtasks: Reorientation (a goal position and orientation, four keypoints on
the cube's diagonals), Regrasping (a goal position, one keypoint at the
centre; a success ends the episode with the successes carried) and Throw
(Regrasping's rule with the goal volume out of the arm's reach).

The scene composes the arm (23 scalar dofs, the arm's 7 first, its base
fixed at the origin), a free 5 cm cube and a fixed table (0.6 x 0.45 x 0.08
m, its top at z = 0.42) 0.8 m along -y. Contact rows are pair rows only
(`plane_contacts=False`): the cube's eight corners against the table, and
the first six candidates of each fingertip body against the cube; every
AllegroKuka yaml sets `max_active_contacts: 0`, so every row enters the
solve. The 23 actions are position targets scaled to the joint ranges
(`use_pd_targets`; stiffness 40, damping 5 on every dof; zero actions hold
mid-range).

Observations are the `full_state` composition: 93 + 6 per keypoint (117
for Reorientation, 99 with one keypoint). The staged reward pays the
cube's lift until it is lifted (plus a one-time bonus), the fingertips'
approach (distance-delta against the closest so far) until then, the
keypoints' approach to the goal after it, minus the arm's and hand's
velocity penalties, plus a bonus while within the success tolerance. A
success draws a new goal and tightens the tolerance (by
`toleranceCurriculumIncrement`, down to `targetSuccessTolerance`); the
tolerance is carried through resets. The per-step reward terms go out as
`episode_cumulative`; `successes` and `true_objective` as extras. With
`maxConsecutiveSuccesses` the episode length counts from the last
success, for the done test only.

Initial-state bank: with `saveStates` and a `saveStatesFile`, the trainer
takes one (q, qd) snapshot per epoch (`accumulate_env_states`) and
`dump_env_states` appends a sample of them (per env `len // 10`, at most
50, once more than 20 are held) to the .npz file; with `loadInitialStates`
and a `loadStatesFile`, every reset takes (q, qd) from a random row of
that bank, the PD targets staying at the fresh draw.

The JAX task keeps a PRNG key in its task state for the goal draws; the
port draws them from the env state's generator in `draws_of_step` (a
declared difference: the streams differ; tests hand the port JAX's draws).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import maths
from ..envcore.vec_task import VecTask
from ..model import load_urdf
from ..model.compose import compose
from ..utils.assets import asset_path
from .franka_cube_stack import _box_actor

OBJ_SIZE = 0.05
TABLE_TOP = 0.42  # the table's centre at z 0.38, half its thickness above
FINGERTIPS = ("index_link_3", "middle_link_3", "ring_link_3", "thumb_link_3")
KUKA_URDF = "urdf/kuka_allegro_description/kuka_allegro_touch_sensor.urdf"
TIPS_PER_FINGER = 6  # candidates per fingertip body kept as pair rows against the cube
REW_TERMS = ("fingertip_delta_rew", "lifting_rew", "lift_bonus_rew", "keypoint_rew", "kuka_actions_penalty",
             "allegro_actions_penalty", "bonus_rew")


def kuka_arm():
    """The arm with its drives: stiffness 40 and damping 5 on every dof,
    effort 300 on the arm's 7 and 0.35 on the hand's 16."""
    arm = load_urdf(asset_path(KUKA_URDF), fix_base=True)
    nv = arm.nv
    return arm.replace(dof_stiffness=np.full(nv, 40.0, np.float32), dof_damping=np.full(nv, 5.0, np.float32),
                       dof_max_effort=np.concatenate([np.full(7, 300.0), np.full(16, 0.35)]).astype(np.float32))


def cube_and_tip_rows(model, cube_body: int, table_body: int, tips):
    """The model keeping only the cube's corners (pair rows against the
    table's geom) and the first TIPS_PER_FINGER candidates of each body in
    `tips` (pair rows against the cube's geom), without plane rows."""
    cube_geom = next(g for g in range(model.ngeom) if model.geom_body[g] == cube_body)
    table_geom = next(g for g in range(model.ngeom) if model.geom_body[g] == table_body)
    keep, geoms, per_tip = [], [], {}
    for c in range(model.ncp):
        b = model.cpoint_body[c]
        if b == cube_body:
            keep.append(c)
            geoms.append(table_geom)
        elif b in tips and per_tip.get(b, 0) < TIPS_PER_FINGER:
            per_tip[b] = per_tip.get(b, 0) + 1
            keep.append(c)
            geoms.append(cube_geom)
    karr = np.asarray(keep)
    return model.replace(cpoint_body=tuple(model.cpoint_body[c] for c in keep),
                         cpoint_pos=np.asarray(model.cpoint_pos)[karr],
                         cpoint_radius=np.asarray(model.cpoint_radius)[karr],
                         cpoint_friction=np.asarray(model.cpoint_friction)[karr],
                         ppair_point=tuple(range(len(keep))), ppair_geom=tuple(geoms), plane_contacts=False)


class AllegroKukaReorientation(VecTask):
    use_pd_targets = True
    NUM_ARMS = 1
    # keypoint offsets in units of the keypoint scale: the cube's four diagonals
    KP_OFFSETS = ((1, 1, 1), (1, 1, -1), (-1, -1, 1), (-1, -1, -1))
    REW_TERMS = REW_TERMS

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        env.setdefault("episodeLength", 600)
        self.lifting_rew_scale = float(env.get("liftingRewScale", 20.0))
        self.lifting_bonus = float(env.get("liftingBonus", 300.0))
        self.lifting_threshold = float(env.get("liftingBonusThreshold", 0.15))
        self.keypoint_rew_scale = float(env.get("keypointRewScale", 200.0))
        self.dist_delta_rew_scale = float(env.get("distanceDeltaRewScale", 50.0))
        self.reach_goal_bonus = float(env.get("reachGoalBonus", 1000.0))
        self.kuka_pen_scale = float(env.get("kukaActionsPenaltyScale", 0.003))
        self.allegro_pen_scale = float(env.get("allegroActionsPenaltyScale", 0.0003))
        self.success_tolerance = float(env.get("successTolerance", 0.075))
        self.target_tolerance = float(env.get("targetSuccessTolerance", 0.01))
        self.tolerance_decay = float(env.get("toleranceCurriculumIncrement", 0.9))
        self.max_consecutive_successes = int(env.get("maxConsecutiveSuccesses", 50))
        self.success_steps = int(env.get("successSteps", 1))
        self.keypoint_scale = float(env.get("keypointScale", 1.5)) * OBJ_SIZE
        self.num_keypoints = len(self.KP_OFFSETS)
        self.num_obs = self._full_state_size()
        self.num_acts = 23 * self.NUM_ARMS
        self.save_states = bool(env.get("saveStates", False))
        self.save_states_file = str(env.get("saveStatesFile", ""))
        self.load_initial_states = bool(env.get("loadInitialStates", False))
        self.load_states_file = str(env.get("loadStatesFile", ""))
        self._episode_q, self._episode_qd = [], []  # host-side snapshots (N, nq), (N, nv)
        self.initial_q = self.initial_qd = None
        super().__init__(cfg, device)
        self._setup()
        if self.load_initial_states:
            self._load_initial_states()
        self._rng = None  # the generator of the state being stepped (`step`)

    def _full_state_size(self):
        return 93 + 6 * self.num_keypoints

    def dr_actor_ranges(self):
        return getattr(self, "_actor_ranges", None)

    def build_model(self):
        cube = _box_actor("cube", [OBJ_SIZE] * 3, 400.0, False, [0.0, -0.8, TABLE_TOP + 0.25])
        table = _box_actor("table", [0.6, 0.45, 0.08], 1000.0, True, [0.0, -0.8, TABLE_TOP - 0.04])
        model, refs = compose([kuka_arm(), cube, table], ["", "cube:", "table:"])
        _, self.cube_ref, self.table_ref = refs
        return self._scene(model, {model.body_names.index(t) for t in FINGERTIPS})

    def _scene(self, model, tips):
        self._actor_ranges = {"allegro": (0, self.cube_ref.body0),
                              "object": (self.cube_ref.body0, self.table_ref.body0)}
        return cube_and_tip_rows(model, self.cube_ref.body0, self.table_ref.body0, tips), self.sim_params_from_cfg()

    def _setup(self):
        m, dev = self.model, self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        sdofs = list(self.scalar_dof_indices)  # the arms' and hands' dofs
        self.num_dofs = len(sdofs)
        self.q_idx = long([m.q_adr[m.dof_body[d]] for d in sdofs])
        self.v_idx = long(sdofs)
        self.dof_lower = f32(np.asarray(m.dof_limit_lower)[sdofs])
        self.dof_upper = f32(np.asarray(m.dof_limit_upper)[sdofs])
        arm_dof = np.zeros(len(sdofs), bool)
        for a in range(self.NUM_ARMS):
            arm_dof[23 * a:23 * a + 7] = True
        self._arm_dof = torch.as_tensor(arm_dof, device=dev)
        self.arm_v_idx, self.hand_v_idx = long(np.asarray(sdofs)[arm_dof]), long(np.asarray(sdofs)[~arm_dof])
        self.tip_bodies = long(self._tip_body_ids())
        self.palm_bodies = long(self._palm_body_ids())
        self.palm_offset = f32([0.0, -0.02, 0.16])
        self.oq = m.q_adr[self.cube_ref.body0]
        self.ov = m.v_adr[self.cube_ref.body0]
        self.obj_body = self.cube_ref.body0
        self.obj_init_z = TABLE_TOP + OBJ_SIZE / 2
        self.obj_init_xy = f32([0.0, -0.8])
        self.keypoint_offsets = f32(self.KP_OFFSETS) * self.keypoint_scale
        self._qpos0 = f32(m.qpos0)
        self._x_unit, self._y_unit, self._z_unit = f32([1.0, 0.0, 0.0]), f32([0.0, 1.0, 0.0]), f32([0.0, 0.0, 1.0])
        self._set_goal_volume()

    def _tip_body_ids(self):
        return [self.model.body_names.index(t) for t in FINGERTIPS]

    def _palm_body_ids(self):
        names = self.model.body_names
        palm = next((i for i, n in enumerate(names) if "palm" in n.lower()),
                    int(np.asarray(self.model.body_parent)[self._tip_body_ids()[0]]))
        return [palm]

    def _set_goal_volume(self):
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        self.vol_origin, self.vol_lo, self.vol_hi = f32([0.0, 0.05, 0.8]), f32([-0.4, -0.05, -0.12]), f32(
            [0.4, 0.3, 0.25])

    # ---- the initial-state bank -----------------------------------------
    def accumulate_env_states(self, state):
        """A host-side snapshot of every env's (q, qd)."""
        self._episode_q.append(state.sim.q.detach().cpu().numpy())
        self._episode_qd.append(state.sim.qd.detach().cpu().numpy())

    def dump_env_states(self, path=None, rng=None):
        """With more than 20 snapshots held: per env, `len // 10` of them (at
        most 50) drawn without replacement are appended to the .npz bank at
        `path` (default saveStatesFile) and the snapshots dropped; fewer are
        kept for a later dump. Returns the bank's rows, or 0 when nothing was
        written."""
        path = path or self.save_states_file
        if not path:
            raise ValueError("dump_env_states needs a path or saveStatesFile")
        if not self._episode_q:
            return 0
        rng = np.random.default_rng(rng)
        ep_len = len(self._episode_q)
        if ep_len <= 20:
            return 0
        qs, qds = np.stack(self._episode_q), np.stack(self._episode_qd)  # (T, N, nq), (T, N, nv)
        n_save = min(ep_len // 10, 50)
        rows_q, rows_qd = [], []
        for e in range(qs.shape[1]):
            t_idx = rng.choice(ep_len, size=n_save, replace=False)
            rows_q.append(qs[t_idx, e])
            rows_qd.append(qds[t_idx, e])
        self._episode_q, self._episode_qd = [], []
        new_q, new_qd = np.concatenate(rows_q), np.concatenate(rows_qd)
        if os.path.exists(path):
            old = np.load(path)
            new_q, new_qd = np.concatenate([old["q"], new_q]), np.concatenate([old["qd"], new_qd])
        np.savez(path, q=new_q, qd=new_qd)
        return len(new_q)

    def _load_initial_states(self):
        bank = np.load(self.load_states_file)
        q, qd = bank["q"], bank["qd"]
        if q.shape[1] != self.model.nq or qd.shape[1] != self.model.nv:
            raise ValueError(f"state bank shape {q.shape}/{qd.shape} does not match model nq={self.model.nq} "
                             f"nv={self.model.nv}")
        self.initial_q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        self.initial_qd = torch.as_tensor(qd, dtype=torch.float32, device=self.device)

    # ---- draws and init ---------------------------------------------------
    def _rotation(self, u):
        """Rotations (n, 4) from draws u (n, 2) uniform in [-1, 1): the
        reference's two-angle randomize_rotation."""
        n = u.shape[0]
        return maths.quat_mul(maths.quat_from_angle_axis(u[:, 0] * np.pi, self._x_unit.expand(n, 3)),
                              maths.quat_from_angle_axis(u[:, 1] * np.pi, self._y_unit.expand(n, 3)))

    def goal_from_draws(self, goal_u):
        """Goals (pos (n, 3), rot (n, 4)) from a goal draw: pos_u (n, 3)
        uniform in [0, 1) over the goal volume, rot_u (n, 2) uniform in [-1,
        1) (and, two arms, side_u (n,) in [0, 1))."""
        pos_u, rot_u = goal_u[:2]
        pos = self.vol_origin + self.vol_lo + pos_u * (self.vol_hi - self.vol_lo)
        return pos, self._rotation(rot_u)

    def _goal_draws(self, g, n):
        dev = self.device
        return torch.rand(n, 3, generator=g, device=dev), torch.rand(n, 2, generator=g, device=dev) * 2 - 1

    def draws_of_step(self, n):
        """The draws of one step's reward: a new goal per env (pos_u (n, 3)
        in [0, 1), rot_u (n, 2) in [-1, 1), and with two arms side_u (n,)
        in [0, 1)), from the stepped state's generator."""
        return self._goal_draws(self._rng, n)

    def step(self, state, actions):
        self._rng = state.rng
        return super().step(state, actions)

    def init_draws(self, g, n):
        """The draws of n resets: dof_u, vel_u (n, dofs) and xy_u (n, 2)
        uniform in [-1, 1), yaw (n,) uniform in [-pi, pi), the goal's draws,
        and the bank rows (n,) (None without a loaded bank)."""
        dev, nd = self.device, self.num_dofs
        u = lambda *shape: torch.rand(*shape, generator=g, device=dev) * 2 - 1
        dof_u, vel_u, xy_u = u(n, nd), u(n, nd), u(n, 2)
        yaw = u(n) * np.pi
        goal_u = self._goal_draws(g, n)
        rows = None if self.initial_q is None else torch.randint(0, self.initial_q.shape[0], (n,), generator=g,
                                                                 device=dev)
        return dof_u, vel_u, xy_u, yaw, goal_u, rows

    def init_from_draws(self, dof_u, vel_u, xy_u, yaw, goal_u, rows, tolerance, successes=None):
        """Init states (q, qd, task) from the draws of `init_draws`, at the
        per-env success tolerance (n,) and, where given, successes (n,)."""
        n, m, dev = dof_u.shape[0], self.model, self.device
        dof = torch.clamp(0.1 * dof_u, self.dof_lower, self.dof_upper)
        q = self._qpos0.repeat(n, 1)
        q[:, self.q_idx] = dof
        qd = torch.zeros(n, m.nv, device=dev)
        qd[:, self.v_idx] = 0.1 * vel_u
        oq = self.oq
        q[:, oq:oq + 2] = self.obj_init_xy + 0.1 * xy_u
        q[:, oq + 2] = self.obj_init_z
        q[:, oq + 3:oq + 7] = maths.quat_from_angle_axis(yaw, self._z_unit.expand(n, 3))
        if rows is not None:  # a reset from the bank; the PD targets stay at the fresh draw
            q, qd = self.initial_q[rows], self.initial_qd[rows]
        goal_pos, goal_rot = self.goal_from_draws(goal_u)
        z = torch.zeros(n, device=dev)
        task = {"goal_pos": goal_pos, "goal_rot": goal_rot,
                "successes": z.clone() if successes is None else successes,
                "near_goal_steps": torch.zeros(n, dtype=torch.int32, device=dev),
                "lifted": torch.zeros(n, dtype=torch.bool, device=dev),
                "closest_tip_dist": -torch.ones(n, 4 * self.NUM_ARMS, device=dev),
                "closest_kp_dist": -torch.ones(n, device=dev), "tolerance": tolerance, "targets": dof,
                "last_success": torch.zeros(n, dtype=torch.bool, device=dev),
                "rew_terms": {k: z.clone() for k in self.REW_TERMS}}
        return q, qd, task

    def sample_init(self, generator, n):
        return self.init_from_draws(*self.init_draws(generator, n),
                                    torch.full((n,), self.success_tolerance, device=self.device))

    def resample_init(self, generator, old_task):
        """The success tolerance's curriculum persists across resets."""
        return self.init_from_draws(*self.init_draws(generator, self.num_envs), old_task["tolerance"])

    # ---- control ----------------------------------------------------------
    def compute_force(self, actions, q, qd, task):
        """PD targets over every dof: the actions scaled to the joint ranges."""
        n, m = q.shape[0], self.model
        cur = torch.clamp(maths.scale(actions, self.dof_lower, self.dof_upper), self.dof_lower, self.dof_upper)
        q_target = q.new_zeros(n, m.nq)
        q_target[:, self.q_idx] = cur
        return q.new_zeros(n, m.nv), q.new_zeros(n, m.nbody, 6), q_target

    # ---- observations -----------------------------------------------------
    def _keypoints(self, pos, quat):
        """(n, K, 3) keypoints of poses (n, 3), (n, 4)."""
        n, k = pos.shape[0], self.num_keypoints
        return pos[:, None] + maths.quat_rotate(quat[:, None].expand(n, k, 4), self.keypoint_offsets.expand(n, k, 3))

    def _palms(self, kin):
        """Palm centres (n, arms, 3), orientations (n, arms, 4), linear
        velocities at the centres (n, arms, 3), angular velocities (n, arms, 3)."""
        idx = self.palm_bodies
        quat, v = kin.quat[:, idx], kin.v[:, idx]
        pos = kin.x[:, idx] + maths.quat_rotate(quat, self.palm_offset.expand(quat.shape[:-1] + (3,)))
        return pos, quat, v[..., 3:] + torch.linalg.cross(v[..., :3], pos, dim=-1), v[..., :3]

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        n, oq, ov = q.shape[0], self.oq, self.ov
        obj_pos, obj_rot = q[:, oq:oq + 3], q[:, oq + 3:oq + 7]
        palm, palm_quat, palm_lin, palm_ang = self._palms(kin)
        tips = kin.x[:, self.tip_bodies]
        kp_obj, kp_goal = self._keypoints(obj_pos, obj_rot), self._keypoints(task["goal_pos"], task["goal_rot"])
        kp_dist = torch.linalg.vector_norm(kp_obj - kp_goal, dim=-1)
        tip_dist = torch.linalg.vector_norm(tips - obj_pos[:, None], dim=-1)
        return torch.cat([
            q[:, self.q_idx], qd[:, self.v_idx], palm[:, 0], palm_quat[:, 0], palm_lin[:, 0], palm_ang[:, 0], obj_rot,
            qd[:, ov:ov + 3], qd[:, ov + 3:ov + 6], (tips - obj_pos[:, None]).reshape(n, -1),
            (kp_obj - kp_goal).reshape(n, -1), (kp_obj - obj_pos[:, None]).reshape(n, -1),
            q.new_full((n, 3), OBJ_SIZE), kp_dist.amax(-1, keepdim=True), task["lifted"].float()[:, None],
            (progress.float() / self.max_episode_length)[:, None], task["successes"][:, None], tip_dist,
            q.new_zeros(n, 1),  # the reference's last-reward slot
        ], -1)

    # ---- the staged reward --------------------------------------------------
    def _action_penalties(self, qd):
        """(arm penalty, hand penalty) (n,) on the dofs' velocities."""
        return (-self.kuka_pen_scale * qd[:, self.arm_v_idx].abs().sum(-1),
                -self.allegro_pen_scale * qd[:, self.hand_v_idx].abs().sum(-1))

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        n, oq = q.shape[0], self.oq
        obj_pos, obj_rot = q[:, oq:oq + 3], q[:, oq + 3:oq + 7]
        tips = kin.x[:, self.tip_bodies]

        # lifting
        z_lift = 0.05 + obj_pos[:, 2] - self.obj_init_z
        was_lifted = task["lifted"]
        lifted = (z_lift > self.lifting_threshold) | was_lifted
        lifting_rew = torch.clamp(z_lift, 0.0, 0.5) * (~lifted) * self.lifting_rew_scale
        lift_bonus = self.lifting_bonus * (lifted & ~was_lifted)

        # the fingertips' approach (distance-delta against the closest so far)
        tip_dist = torch.linalg.vector_norm(tips - obj_pos[:, None], dim=-1)
        closest = torch.where(task["closest_tip_dist"] < 0, tip_dist, task["closest_tip_dist"])
        tip_delta = torch.clamp(closest - tip_dist, 0.0, 10.0)
        closest = torch.minimum(closest, tip_dist)
        tip_delta_rew = tip_delta.sum(-1) * self.dist_delta_rew_scale
        if self.NUM_ARMS == 1:  # the second arm stays close at all times: the two-arm reward is not gated
            tip_delta_rew = tip_delta_rew * (~lifted)

        # the keypoints' approach, once lifted
        kp_obj, kp_goal = self._keypoints(obj_pos, obj_rot), self._keypoints(task["goal_pos"], task["goal_rot"])
        kp_max = torch.linalg.vector_norm(kp_obj - kp_goal, dim=-1).amax(-1)
        closest_kp = torch.where(task["closest_kp_dist"] < 0, kp_max, task["closest_kp_dist"])
        kp_rew = torch.clamp(closest_kp - kp_max, 0.0, 100.0) * lifted * self.keypoint_rew_scale
        closest_kp = torch.minimum(closest_kp, kp_max)

        # success: within tolerance for successSteps steps
        near_goal = kp_max <= task["tolerance"] * self.keypoint_scale / OBJ_SIZE
        near_goal_steps = task["near_goal_steps"] + near_goal
        is_success = near_goal_steps >= self.success_steps
        successes = task["successes"] + is_success
        bonus = near_goal * (self.reach_goal_bonus / self.success_steps)

        terms = {"fingertip_delta_rew": tip_delta_rew, "lifting_rew": lifting_rew, "lift_bonus_rew": lift_bonus,
                 "keypoint_rew": kp_rew}
        reward = lifting_rew + lift_bonus + tip_delta_rew + kp_rew
        if "kuka_actions_penalty" in self.REW_TERMS:
            kuka_pen, allegro_pen = self._action_penalties(qd)
            terms.update(kuka_actions_penalty=kuka_pen, allegro_actions_penalty=allegro_pen)
            reward = reward + (kuka_pen + allegro_pen)
        terms["bonus_rew"] = bonus
        reward = reward + bonus

        # a new goal and a tighter tolerance on success
        new_pos, new_rot = self.goal_from_draws(self.draws_of_step(n))
        goal_pos = torch.where(is_success[:, None], new_pos, task["goal_pos"])
        goal_rot = torch.where(is_success[:, None], new_rot, task["goal_rot"])
        tolerance = torch.where(is_success, torch.clamp(task["tolerance"] * self.tolerance_decay,
                                                        min=self.target_tolerance), task["tolerance"])
        near_goal_steps = torch.where(is_success, torch.zeros_like(near_goal_steps), near_goal_steps)
        closest_kp = torch.where(is_success, -torch.ones_like(closest_kp), closest_kp)

        # the episode length counts from the last success, for the done test only
        progress = torch.where(is_success, torch.zeros_like(progress), progress)
        done = (obj_pos[:, 2] < 0.1) | (successes >= self.max_consecutive_successes) | (
            progress >= self.max_episode_length - 1)
        new_task = {"goal_pos": goal_pos, "goal_rot": goal_rot, "successes": successes,
                    "near_goal_steps": near_goal_steps, "lifted": lifted, "closest_tip_dist": closest,
                    "closest_kp_dist": closest_kp, "tolerance": tolerance, "targets": task["targets"],
                    "last_success": is_success, "rew_terms": terms}
        return reward, done, new_task

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        """The consecutive successes (also as the PBT objective) and the
        per-step reward terms."""
        return {"true_objective": task["successes"], "successes": task["successes"],
                "episode_cumulative": task["rew_terms"]}

    # ---- comparison states ------------------------------------------------
    def contact_states(self, n: int, seed: int, cube_scale=None):
        """n states (q, qd) for holding the kernel against its plain
        version: the arms' joints at a reset's draws, the hands' in the
        middle 60 % of their ranges; in two envs of three the cube (at a
        random yaw) resting on the highest fingertip candidate, its bottom
        face 0-0.5 mm into the candidate's sphere and its centre within 1 cm
        of it in x and y; in the third the cube resting on the table at a random yaw,
        its corners 0-0.5 mm into the top; gentle velocities. Drawn with
        numpy from `seed`. `cube_scale` (n,), the per-env scale of a domain
        randomization draw, sizes the cube where given."""
        from ..engine.dynamics import forward_kinematics

        m, rng, dev = self.model, np.random.RandomState(seed), self.device
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
        nd = self.num_dofs
        zeros = lambda *s: torch.zeros(*s, device=dev)
        q, _, _ = self.init_from_draws(f32(rng.uniform(-1, 1, (n, nd))), zeros(n, nd), f32(rng.uniform(-1, 1, (n, 2))),
                                       f32(rng.uniform(-np.pi, np.pi, n)), (zeros(n, 3), zeros(n, 2), zeros(n)), None,
                                       zeros(n))
        mid = self.dof_lower + (self.dof_upper - self.dof_lower) * f32(rng.uniform(0.2, 0.8, (n, nd)))
        q[:, self.q_idx] = torch.where(self._arm_dof, q[:, self.q_idx], mid)
        kin = forward_kinematics(m, q, zeros(n, m.nv))
        cb = torch.as_tensor(np.asarray(m.cpoint_body), device=dev)
        pts = kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], f32(m.cpoint_pos).expand(n, -1, 3))
        rad = f32(m.cpoint_radius)
        tip = (cb != self.obj_body).expand(n, -1)
        top = torch.where(tip, pts[..., 2] + rad, torch.full_like(rad, -1e9)).argmax(1)
        ar = torch.arange(n, device=dev)
        centre = pts[ar, top] + torch.cat([f32(rng.uniform(-0.01, 0.01, (n, 2))), zeros(n, 1)], -1)
        half = OBJ_SIZE / 2 * (torch.ones(n, device=dev) if cube_scale is None else cube_scale.reshape(n))
        centre[:, 2] += rad[top] + half - f32(rng.uniform(0.0, 5e-4, n))
        held = ar % 3 != 2
        oq = self.oq
        q[:, oq:oq + 3] = torch.where(held[:, None], centre, q[:, oq:oq + 3])
        on_table = q[:, oq + 2] + half - OBJ_SIZE / 2 - f32(rng.uniform(0.0, 5e-4, n))
        q[:, oq + 2] = torch.where(held, q[:, oq + 2], on_table)
        qd = f32(rng.uniform(-0.01, 0.01, (n, m.nv)))
        return q, qd


class AllegroKukaRegrasping(AllegroKukaReorientation):
    """A goal position only (one keypoint at the cube's centre); a success
    ends the episode, the cube goes back on the table, and the successes
    and the tolerance carry into the next episode."""

    KP_OFFSETS = ((0, 0, 0),)

    def resample_init(self, generator, old_task):
        successes = torch.where(old_task["last_success"], old_task["successes"],
                                torch.zeros_like(old_task["successes"]))
        return self.init_from_draws(*self.init_draws(generator, self.num_envs), old_task["tolerance"], successes)

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        reward, done, new_task = super().reward_done(obs, q, qd, kin, sensors, task, actions, progress)
        return reward, done | new_task["last_success"], new_task


class AllegroKukaThrow(AllegroKukaRegrasping):
    """Regrasping with the goal volume beyond the arm's reach (x in [-1, 1],
    y in [1.1, 2], z in [0.25, 0.45]): the cube must be thrown."""

    def _set_goal_volume(self):
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        self.vol_origin, self.vol_lo, self.vol_hi = f32([0.0, 1.5, 0.35]), f32([-1.0, -0.4, -0.1]), f32(
            [1.0, 0.5, 0.1])
