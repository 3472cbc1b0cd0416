"""AllegroKukaTwoArms: two KUKA + Allegro arms either side of a shared
table; the goal lies toward one arm at random, so the cube is handed over
(port of isaacgymenvs_tpu/tasks/allegro_kuka_two_arms.py), batched over
envs. Two subtasks: Reorientation and Regrasping (one keypoint at the
cube's centre; a success ends the episode with the successes carried).

The arms stand at x = -armXOfs and +armXOfs (y = armYOfs), unturned; the
table (1.1 x 0.4 x 0.3 m, its top at z = 0.53) and the cube between them.
Contact rows are the cube's corners against the table and six candidates
of each of the eight fingertips against the cube, every one in the solve
(no cap). The 46 actions are both arms' position targets.

Observations (`full_state`): per arm the dofs' positions and velocities,
the palm's pose and velocity, the fingertips relative to the cube and the
keypoints relative to the palm; then the cube's orientation and
velocities, the keypoints relative to the goal and the single-arm tail:
160 + 9 per keypoint (196, or 169 with one). The reward is the single-arm
one without the action penalties, and the fingertips' approach of both
arms is paid whether or not the cube is lifted. The goal volume is 0.4 x
1.0 x 0.37 m about (0, 0, 0.8), moved 0.75 m along x toward a random arm.
As in the JAX package, `loadInitialStates` loads the bank but the resets
do not draw from it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..model.compose import compose
from .allegro_kuka import OBJ_SIZE, FINGERTIPS, AllegroKukaReorientation, kuka_arm
from .franka_cube_stack import _box_actor

TABLE_TOP = 0.53  # the wide table: a 1.1 x 0.4 x 0.3 m box centred at z 0.38
REW_TERMS = ("fingertip_delta_rew", "lifting_rew", "lift_bonus_rew", "keypoint_rew", "bonus_rew")


class AllegroKukaTwoArmsReorientation(AllegroKukaReorientation):
    NUM_ARMS = 2
    REW_TERMS = REW_TERMS

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self.arm_x_ofs = float(env.get("armXOfs", 1.1))
        self.arm_y_ofs = float(env.get("armYOfs", 0.0))
        super().__init__(cfg, device)

    def _full_state_size(self):
        arms, k = self.NUM_ARMS, self.num_keypoints
        return 2 * 23 * arms + 13 * arms + 10 + 12 * arms + 3 * k * arms + 3 * k + 8

    def build_model(self):
        arms = []
        for i in range(self.NUM_ARMS):
            arm = kuka_arm()
            body_pos = np.asarray(arm.body_pos).copy()
            body_pos[0] = [self.arm_x_ofs * (-1 if i == 0 else 1), self.arm_y_ofs, 0.0]
            arms.append(arm.replace(body_pos=body_pos))
        cube = _box_actor("cube", [OBJ_SIZE] * 3, 400.0, False, [0.0, self.arm_y_ofs, TABLE_TOP + 0.25])
        table = _box_actor("table", [1.1, 0.4, 0.3], 1000.0, True, [0.0, self.arm_y_ofs, TABLE_TOP - 0.15])
        model, refs = compose(arms + [cube, table], ["a0:", "a1:", "cube:", "table:"])
        self.cube_ref, self.table_ref = refs[self.NUM_ARMS:]
        return self._scene(model, {model.body_names.index(f"a{i}:{t}") for t in FINGERTIPS
                                   for i in range(self.NUM_ARMS)})

    def _setup(self):
        super()._setup()
        self.obj_init_z = TABLE_TOP + OBJ_SIZE / 2
        self.obj_init_xy = torch.tensor([0.0, self.arm_y_ofs], device=self.device)

    def _tip_body_ids(self):
        names = self.model.body_names
        return [names.index(f"a{i}:{t}") for i in range(self.NUM_ARMS) for t in FINGERTIPS]

    def _palm_body_ids(self):
        names = self.model.body_names
        return [next(j for j, n in enumerate(names) if n.startswith(f"a{i}:") and "palm" in n.lower())
                for i in range(self.NUM_ARMS)]

    def _set_goal_volume(self):
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        self.vol_origin, self.vol_lo, self.vol_hi = f32([0.0, 0.0, 0.8]), f32([-0.2, -0.5, -0.12]), f32(
            [0.2, 0.5, 0.25])

    def goal_from_draws(self, goal_u):
        """The single-arm goal, moved 0.75 m along x toward arm 1 where
        side_u > 0.5, toward arm 0 elsewhere."""
        pos, rot = super().goal_from_draws(goal_u)
        side = torch.where(goal_u[2] > 0.5, 0.75, -0.75)
        return pos + torch.stack([side, torch.zeros_like(side), torch.zeros_like(side)], -1), rot

    def _goal_draws(self, g, n):
        return (*super()._goal_draws(g, n), torch.rand(n, generator=g, device=self.device))

    def init_draws(self, g, n):
        """The one arm's reset draws without bank rows: the two-arm resets
        never take a loaded bank's states (as the JAX package's)."""
        return (*super().init_draws(g, n)[:5], None)

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        n, oq, ov = q.shape[0], self.oq, self.ov
        obj_pos, obj_rot = q[:, oq:oq + 3], q[:, oq + 3:oq + 7]
        palms, palm_quat, palm_lin, palm_ang = self._palms(kin)
        tips = kin.x[:, self.tip_bodies]
        kp_obj, kp_goal = self._keypoints(obj_pos, obj_rot), self._keypoints(task["goal_pos"], task["goal_rot"])
        kp_dist = torch.linalg.vector_norm(kp_obj - kp_goal, dim=-1)
        flat = lambda t: t.reshape(n, -1)
        return torch.cat([
            q[:, self.q_idx], qd[:, self.v_idx], flat(palms), flat(palm_quat), flat(palm_lin), flat(palm_ang), obj_rot,
            qd[:, ov:ov + 3], qd[:, ov + 3:ov + 6], flat(tips - obj_pos[:, None]),
            flat(kp_obj[:, None] - palms[:, :, None]), flat(kp_obj - kp_goal), q.new_full((n, 3), OBJ_SIZE),
            kp_dist.amax(-1, keepdim=True), task["lifted"].float()[:, None],
            (progress.float() / self.max_episode_length)[:, None], task["successes"][:, None],
            q.new_zeros(n, 1),  # the reference's last-reward slot
        ], -1)


class AllegroKukaTwoArmsRegrasping(AllegroKukaTwoArmsReorientation):
    """A goal position only (one keypoint at the cube's centre), toward a
    random arm; a success ends the episode with the successes and the
    tolerance carried."""

    KP_OFFSETS = ((0, 0, 0),)

    def resample_init(self, generator, old_task):
        successes = torch.where(old_task["last_success"], old_task["successes"],
                                torch.zeros_like(old_task["successes"]))
        return self.init_from_draws(*self.init_draws(generator, self.num_envs), old_task["tolerance"], successes)

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        reward, done, new_task = super().reward_done(obs, q, qd, kin, sensors, task, actions, progress)
        return reward, done | new_task["last_success"], new_task
