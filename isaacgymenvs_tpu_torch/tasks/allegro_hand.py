"""AllegroHand: in-hand reorientation with the 16-dof Allegro hand (port
of isaacgymenvs_tpu/tasks/allegro_hand.py), batched over envs.

ShadowHand's reward, goals and targets with the Allegro hand: all 16 dofs
actuated, drives of stiffness 3, damping 0.1 and effort 0.5; the hand's
root at z = 0.5 turned by Ry(pi) Rx(0.47 pi) Rz(0.25 pi) (the right
operand first) so that the palm faces up; the object's start
`startObjectPoseDY` / `startObjectPoseDZ` from the hand. Observations
`full_no_vel` / `no_vel` (50), `full` (72) or `full_state` (88); the
no-velocity layout has the dict keys of the reference's dict-observation
envs (`obs_spec`: dof_pos, object_pose_cam, goal_pose,
goal_relative_rot_cam, last_actions), which per-key observation noise reads.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import maths
from ..model import load_urdf
from ..utils.assets import asset_path
from .franka_cube_stack import _qmul_np, _quat_np
from .shadow_hand import ShadowHand


class AllegroHand(ShadowHand):
    fingertip_names = ("index_biotac_tip", "middle_biotac_tip", "ring_biotac_tip", "thumb_biotac_tip")
    OBS_DIMS = {"no_vel": 50, "full_no_vel": 50, "full": 72, "full_state": 88}
    STATE_DIM = 88

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        env.setdefault("episodeLength", 600)
        env.setdefault("observationType", "full_state")
        super().__init__(cfg, device)
        self.num_acts = 16

    def obs_spec(self):
        """{key: (offset, size)} of the no-velocity observation, in the
        reference's dict-observation key names; None for the other layouts."""
        if self.obs_type not in ("no_vel", "full_no_vel"):
            return None
        return {"dof_pos": (0, 16), "object_pose_cam": (16, 7), "goal_pose": (23, 7),
                "goal_relative_rot_cam": (30, 4), "last_actions": (34, 16)}

    def build_model(self):
        env = self.cfg["env"]
        asset = env.get("asset", {})
        hand = load_urdf(asset_path(asset.get("assetFileName", "urdf/kuka_allegro_description/allegro_touch_sensor.urdf")),
                         fix_base=True)
        nv = hand.nv
        hand = hand.replace(dof_stiffness=np.full(nv, 3.0, np.float32), dof_damping=np.full(nv, 0.1, np.float32),
                            dof_max_effort=np.full(nv, 0.5, np.float32))
        obj = load_urdf(asset_path(asset.get("assetFileNameBlock", "urdf/objects/cube_multicolor_allegro.urdf")))
        rot = _qmul_np(_quat_np((0, 1, 0), np.pi),
                       _qmul_np(_quat_np((1, 0, 0), 0.47 * np.pi), _quat_np((0, 0, 1), 0.25 * np.pi)))
        return self._hand_scene(hand, obj, (0.0, 0.0, 0.5), rot.astype(np.float32))

    def _setup_indices(self):
        super()._setup_indices()
        dev = self.device
        self.actuated_idx = torch.arange(self.num_hand_dofs, device=dev)  # every dof
        dy = float(self.cfg["env"].get("startObjectPoseDY", -0.2))
        dz = float(self.cfg["env"].get("startObjectPoseDZ", 0.06))
        self.object_start_pos = torch.tensor([0.0, dy, 0.5 + dz], device=dev)
        self.goal_start_pos = self.object_start_pos + torch.tensor([0.0, 0.0, -0.04], device=dev)

    def _obs_impl(self, q, qd, kin, sensors, task, actions, obs_type):
        n = q.shape[0]
        obj_pos, obj_rot, obj_linvel, obj_angvel = self._object_state(q, qd)
        goal_rot = task["goal_rot"]
        goal_pos = self.goal_start_pos.expand(n, 3)
        quat_diff = maths.quat_mul(obj_rot, maths.quat_conjugate(goal_rot))
        scaled_pos = maths.unscale(q[:, self.hand_q_idx], self.dof_lower, self.dof_upper)
        if obs_type in ("full_no_vel", "no_vel"):
            return torch.cat([scaled_pos, obj_pos, obj_rot, goal_pos, goal_rot, quat_diff, actions], -1)
        obj = [obj_pos, obj_rot, obj_linvel, self.vel_obs_scale * obj_angvel, goal_pos, goal_rot, quat_diff]
        dof_vel = self.vel_obs_scale * qd[:, self.hand_v_idx]
        if obs_type == "full":
            return torch.cat([scaled_pos, dof_vel, *obj, actions], -1)
        return torch.cat([scaled_pos, dof_vel, self.force_torque_obs_scale * sensors.dof_force[:, self.hand_v_idx],
                          *obj, actions], -1)
