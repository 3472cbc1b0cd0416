"""FrankaCabinet: open a cabinet's top drawer with a Franka arm (port of
isaacgymenvs_tpu/tasks/franka_cabinet.py), batched over envs.

The Franka (base at (1, 0, 0), yawed by 180 degrees) and the cabinet (at
(0, 0, 0.4)) compose into one fixed-base forest. The actions move
integrated joint position targets (carried in the task state as `targets`,
`actionScale` x dt per step, clipped to the joint limits) that the joints'
position drives follow (stiffness 400 on the arm and 1e6 on the fingers,
damping 80 and 100); the cabinet's joints have damping 10. The hand's and
fingers' box corners pair against the top drawer handle's bar, a MESH geom
on the cylinder branch, so the drawer moves under contact forces (24 pair
rows, the cfg's cap of 16 active). The 23 observations are the Franka's
scaled joint positions and velocities, the vector from the Franka's grasp
frame to the drawer's, and the top drawer's position and velocity. The
reward is the reference's: distance, alignment of the grasp frames, the
around-handle and finger-distance terms, the opening with its bonuses, an
action penalty, and -1 where a finger passes the handle; an episode ends
when the drawer is open past 0.39 m or at its length.

The cabinet is the hand-written stand-in of the public asset
(assets/urdf/sektion_cabinet_model); the real asset takes its place once it
is in the repository.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import controllers, maths
from ..engine import dynamics as _dyn
from ..envcore.vec_task import VecTask
from ..model import load_urdf
from ..model.compose import compose
from ..utils.assets import asset_path


class FrankaCabinet(VecTask):
    use_pd_targets = True
    uses_kin = False  # poses from `BodyPoses`

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self.action_scale = float(env.get("actionScale", 7.5))
        self.dof_vel_scale = float(env.get("dofVelocityScale", 0.1))
        self.dist_reward_scale = float(env.get("distRewardScale", 2.0))
        self.rot_reward_scale = float(env.get("rotRewardScale", 0.5))
        self.around_handle_reward_scale = float(env.get("aroundHandleRewardScale", 0.25))
        self.open_reward_scale = float(env.get("openRewardScale", 7.5))
        self.finger_dist_reward_scale = float(env.get("fingerDistRewardScale", 5.0))
        self.action_penalty_scale = float(env.get("actionPenaltyScale", 0.01))
        self.distX_offset = 0.04
        env.setdefault("episodeLength", 500)
        self.num_obs = 23
        self.num_acts = 9
        super().__init__(cfg, device)

        m, dev = self.model, self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        sdofs = self.scalar_dof_indices  # Franka 0-8; door_right, door_left, drawer_top, drawer_bottom
        self.all_q_idx = long([m.q_adr[m.dof_body[d]] for d in sdofs])
        self.all_v_idx = long(sdofs)
        self.dof_lower = f32(np.asarray(m.dof_limit_lower)[sdofs][:9])
        self.dof_upper = f32(np.asarray(m.dof_limit_upper)[sdofs][:9])
        self.default_dof = f32([1.157, -1.066, -0.155, -2.239, -1.841, 1.003, 0.469, 0.035, 0.035])
        self.hand_body = m.body_names.index("panda_link7")
        self.lfinger_body = m.body_names.index("panda_leftfinger")
        self.rfinger_body = m.body_names.index("panda_rightfinger")
        self.drawer_body = m.body_names.index("cab:drawer_top")
        self.drawer_q = 11  # the top drawer's scalar dof: Franka 0-8, then the cabinet's third
        self._qpos0 = f32(m.qpos0)
        self._poses = _dyn.BodyPoses(m, dev)
        self._pose_memo = None  # (q, x, quat) of the last observe
        # grasp frames, once at the default pose: the finger midpoint 4 cm
        # forward in the hand (panda_link7) frame, and a point on the handle
        q0 = self._qpos0.clone()[None]
        q0[:, self.all_q_idx[:9]] = self.default_dof
        x, quat = self._poses(q0)
        hand_q, hand_p = quat[0, self.hand_body], x[0, self.hand_body]
        finger_mid = 0.5 * (x[0, self.lfinger_body] + x[0, self.rfinger_body])
        inv_q, inv_p = maths.tf_inverse(hand_q, hand_p)
        self.franka_local_grasp_pos = maths.tf_apply(inv_q, inv_p, finger_mid) + f32([0.0, 0.0, 0.04])
        self.franka_local_grasp_rot = maths.quat_mul(inv_q, hand_q)  # the identity
        # the reference sets the drawer's local grasp point twice, (0.3, 0.01,
        # 0) and then get_axis_params(0.01, 2, 0.3); the second stands
        self.drawer_local_grasp_pos = f32([0.3, 0.0, 0.01])
        self.drawer_local_grasp_rot = f32([0.0, 0.0, 0.0, 1.0])
        self.gripper_forward_axis = f32([0.0, 0.0, 1.0])
        self.drawer_inward_axis = f32([-1.0, 0.0, 0.0])
        self.gripper_up_axis = f32([0.0, 1.0, 0.0])
        self.drawer_up_axis = f32([0.0, 0.0, 1.0])

    def build_model(self):
        asset = self.cfg["env"].get("asset", {})
        franka = load_urdf(asset_path(asset.get("assetFileNameFranka",
                                                "urdf/franka_description/robots/franka_panda.urdf")), fix_base=True)
        # drive props (reference franka_cabinet.py:163-198)
        stiff = np.array([400, 400, 400, 400, 400, 400, 400, 1.0e6, 1.0e6], np.float32)
        damp = np.array([80, 80, 80, 80, 80, 80, 80, 1.0e2, 1.0e2], np.float32)
        franka = franka.replace(dof_stiffness=stiff, dof_damping=damp)
        cabinet = load_urdf(asset_path(asset.get("assetFileNameCabinet",
                                                 "urdf/sektion_cabinet_model/urdf/sektion_cabinet_2.urdf")),
                            fix_base=True)
        cabinet = cabinet.replace(dof_damping=np.full(cabinet.nv, 10.0, np.float32))
        model, refs = compose([franka, cabinet], ["", "cab:"])
        self.franka_ref, self.cab_ref = refs
        # start poses: the Franka at (1, 0, 0) yawed by 180 degrees, the cabinet at (0, 0, 0.4)
        body_pos = np.asarray(model.body_pos).copy()
        body_quat = np.asarray(model.body_quat).copy()
        body_pos[0] = [1.0, 0.0, 0.0]
        body_pos[self.cab_ref.body0] = [0.0, 0.0, 0.4]
        body_quat[0] = [0.0, 0.0, 1.0, 0.0]
        model = model.replace(body_pos=body_pos, body_quat=body_quat)
        # the hand's and fingers' candidate points against the handle bar,
        # the first geom of the top drawer's handle
        finger_bodies = {model.body_names.index(n) for n in ("panda_leftfinger", "panda_rightfinger", "panda_hand")}
        handle_body = model.body_names.index("cab:drawer_handle_top")
        finger_pts = [c for c in range(model.ncp) if model.cpoint_body[c] in finger_bodies]
        handle_geoms = [g for g in range(model.ngeom) if model.geom_body[g] == handle_body]
        ppp, ppg = [], []
        for g in handle_geoms[:1]:
            ppp += finger_pts
            ppg += [g] * len(finger_pts)
        # everything is fixed-base, off the floor: no plane rows
        model = model.replace(ppair_point=tuple(ppp), ppair_geom=tuple(ppg), plane_contacts=False)
        return model, self.sim_params_from_cfg()

    # ---- init / control -------------------------------------------------
    def sample_init(self, generator, n):
        noise = 0.25 * (torch.rand(n, 9, generator=generator, device=self.device) - 0.5)
        pos = torch.clamp(self.default_dof + noise, self.dof_lower, self.dof_upper)
        q = self._qpos0.repeat(n, 1)
        q[:, self.all_q_idx[:9]] = pos
        q[:, self.all_q_idx[9:]] = 0.0
        return q, q.new_zeros(n, self.model.nv), {"targets": pos}

    def _targets(self, task, actions):
        return torch.clamp(task["targets"] + self.action_scale * self.dt * actions, self.dof_lower, self.dof_upper)

    def compute_force(self, actions, q, qd, task):
        n, m = q.shape[0], self.model
        q_target = q.new_zeros(n, m.nq)
        q_target[:, self.all_q_idx[:9]] = self._targets(task, actions)
        return q.new_zeros(n, m.nv), q.new_zeros(n, m.nbody, 6), q_target

    # ---- observations ---------------------------------------------------
    def _observed_poses(self, q):
        """Body poses at q (`BodyPoses`), kept for the reward of the same step."""
        x, quat = self._poses(q)
        self._pose_memo = (q, x, quat)
        return x, quat

    def _poses_of(self, q):
        """The poses `observe` took at this very q, else fresh ones."""
        memo = self._pose_memo
        return memo[1:] if memo is not None and memo[0] is q else self._poses(q)

    def _grasp_frames(self, x, quat):
        n = x.shape[0]
        ex = lambda t: t.expand(n, t.shape[-1])
        fg_rot, fg_pos = maths.tf_combine(quat[:, self.hand_body], x[:, self.hand_body],
                                          ex(self.franka_local_grasp_rot), ex(self.franka_local_grasp_pos))
        dg_rot, dg_pos = maths.tf_combine(quat[:, self.drawer_body], x[:, self.drawer_body],
                                          ex(self.drawer_local_grasp_rot), ex(self.drawer_local_grasp_pos))
        return fg_rot, fg_pos, dg_rot, dg_pos

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        dof_pos = q[:, self.all_q_idx[:9]]
        dof_scaled = 2.0 * (dof_pos - self.dof_lower) / (self.dof_upper - self.dof_lower) - 1.0
        _, fg_pos, _, dg_pos = self._grasp_frames(*self._observed_poses(q))
        return torch.cat([
            dof_scaled,
            qd[:, self.all_v_idx[:9]] * self.dof_vel_scale,
            dg_pos - fg_pos,
            q[:, self.all_q_idx[11:12]],  # drawer_top_joint
            qd[:, self.all_v_idx[11:12]],
        ], dim=-1)

    # ---- reward ---------------------------------------------------------
    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        x, quat = self._poses_of(q)
        fg_rot, fg_pos, dg_rot, dg_pos = self._grasp_frames(x, quat)
        lf, rf = x[:, self.lfinger_body], x[:, self.rfinger_body]
        drawer_open = q[:, self.all_q_idx[self.drawer_q]]
        n = q.shape[0]
        ex = lambda t: t.expand(n, 3)

        d = torch.linalg.vector_norm(fg_pos - dg_pos, dim=-1)
        dist_reward = (1.0 / (1.0 + d * d)) ** 2
        dist_reward = torch.where(d <= 0.02, dist_reward * 2, dist_reward)

        dot1 = torch.sum(maths.tf_vector(fg_rot, ex(self.gripper_forward_axis))
                         * maths.tf_vector(dg_rot, ex(self.drawer_inward_axis)), dim=-1)
        dot2 = torch.sum(maths.tf_vector(fg_rot, ex(self.gripper_up_axis))
                         * maths.tf_vector(dg_rot, ex(self.drawer_up_axis)), dim=-1)
        rot_reward = 0.5 * (torch.sign(dot1) * dot1 ** 2 + torch.sign(dot2) * dot2 ** 2)

        around = (lf[:, 2] > dg_pos[:, 2]) & (rf[:, 2] < dg_pos[:, 2])
        around_handle_reward = 0.5 * around.float()
        finger_dist_reward = torch.where(
            around, (0.04 - torch.abs(lf[:, 2] - dg_pos[:, 2])) + (0.04 - torch.abs(rf[:, 2] - dg_pos[:, 2])),
            torch.zeros_like(d))
        action_penalty = torch.sum(actions ** 2, dim=-1)
        open_reward = drawer_open * around_handle_reward + drawer_open

        rewards = (self.dist_reward_scale * dist_reward + self.rot_reward_scale * rot_reward
                   + self.around_handle_reward_scale * around_handle_reward + self.open_reward_scale * open_reward
                   + self.finger_dist_reward_scale * finger_dist_reward
                   - self.action_penalty_scale * action_penalty)
        rewards = torch.where(drawer_open > 0.01, rewards + 0.5, rewards)
        rewards = torch.where(drawer_open > 0.2, rewards + around_handle_reward, rewards)
        rewards = torch.where(drawer_open > 0.39, rewards + 2.0 * around_handle_reward, rewards)
        bad = (lf[:, 0] < dg_pos[:, 0] - self.distX_offset) | (rf[:, 0] < dg_pos[:, 0] - self.distX_offset)
        rewards = torch.where(bad, torch.full_like(rewards, -1.0), rewards)
        # the reference resets on success or time-out only; a bad style is a -1, not an end
        done = (drawer_open > 0.39) | (progress >= self.max_episode_length - 1)
        return rewards, done, {"targets": self._targets(task, actions)}

    def true_objective(self, q, qd):
        return q[:, self.all_q_idx[self.drawer_q]]

    def contact_states(self, n: int, seed: int):
        """n states (q, qd) with the hand or a finger on the top drawer's
        handle, for holding the kernel against its plain version: the arm
        joints within 0.1 rad of the default pose and the fingers open 0-4
        cm; damped least-squares IK (`controllers.get_delta_dof_pos`, 8
        steps on the arm) brings one candidate point, drawn per env, within
        5 mm of the handle bar's axis in height and 8 cm of its middle
        along it; the top drawer then opens until the first of the 24
        points the handle meets is 0.2-1 mm inside the bar. The doors and
        the bottom drawer stand open 0.01-0.5, away from their limits;
        gentle velocities. Drawn with numpy from `seed`; the IK runs on the
        env's device."""
        m, rng, dev = self.model, np.random.RandomState(seed), self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        q = self._qpos0.repeat(n, 1)
        q[:, self.all_q_idx[:9]] = self.default_dof + f32(np.concatenate(
            [rng.uniform(-0.1, 0.1, (n, 7)), rng.uniform(-0.035, 0.005, (n, 2))], 1))
        q[:, self.all_q_idx[9:]] = f32(np.stack([-rng.uniform(0.01, 0.5, n), rng.uniform(0.01, 0.5, n),
                                                 np.zeros(n), rng.uniform(0.01, 0.5, n)], 1))
        pts = np.asarray(m.ppair_point)
        body = torch.as_tensor(np.asarray(m.cpoint_body)[pts], device=dev)
        local = f32(np.asarray(m.cpoint_pos)[pts])
        h = m.geom_body[m.ppair_geom[0]]
        handle = self._poses(q[:1])[0][0, h]  # with the drawer shut
        radius, half = float(m.geom_size[m.ppair_geom[0]][0]), float(m.geom_size[m.ppair_geom[0]][1])
        pick = torch.as_tensor(rng.randint(0, len(pts), n), device=dev)
        goal = torch.stack([handle[1] + f32(rng.uniform(-0.08, 0.08, n)),
                            handle[2] + f32(rng.uniform(-0.005, 0.005, n))], 1)
        # the dofs on the path to each env's picked point (N, nv)
        path = f32(_dyn.ancestor_matrix(m))[body[pick]][:, torch.as_tensor(np.asarray(m.dof_body), device=dev)]
        arm = self.all_v_idx[:7]
        rows = torch.arange(n, device=dev)

        def points(kin):
            return kin.x[:, body] + maths.quat_rotate(kin.quat[:, body], local.expand(n, -1, -1))

        for _ in range(8):
            kin = _dyn.forward_kinematics(m, q, torch.zeros(n, m.nv, device=dev))
            p = points(kin)[rows, pick]
            # the point's linear Jacobian rows; the angular rows and x take no part
            lin = (kin.S[..., 3:] + torch.linalg.cross(kin.S[..., :3], p[:, None].expand(n, m.nv, 3), dim=-1))
            J = torch.zeros(n, 6, m.nv, device=dev)
            J[:, 4:] = (lin * path[..., None]).transpose(1, 2)[:, 1:]
            dpose = torch.zeros(n, 6, device=dev)
            dpose[:, 4:] = goal - p[:, 1:]
            q[:, self.all_q_idx[:7]] += controllers.get_delta_dof_pos(dpose, J[:, :, arm], "dls", lam=0.05)
        # open the drawer until the first point of the 24 lies 0.2-1 mm inside the bar (in its cross-section)
        p = points(_dyn.forward_kinematics(m, q, torch.zeros(n, m.nv, device=dev)))
        depth = f32(rng.uniform(2e-4, 1e-3, n))[:, None]
        dz = p[..., 2] - handle[2]
        reach = torch.sqrt(torch.clamp((radius - depth) ** 2 - dz ** 2, min=0.0))
        at = torch.where((dz.abs() < radius - depth) & ((p[..., 1] - handle[1]).abs() < half),
                         p[..., 0] - reach - handle[0], torch.full_like(dz, 1e9))
        q[:, self.all_q_idx[self.drawer_q]] = at.amin(1)
        qd = f32(rng.uniform(-0.01, 0.01, (n, m.nv)))
        return q, qd

