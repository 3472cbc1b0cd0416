"""Cartpole (port of isaacgymenvs_tpu/tasks/cartpole.py), batched over envs.

Observation [cart_pos, cart_vel, pole_angle, pole_vel], reward, termination
and reset sampling copy the JAX task.

One declared difference in the model: `plane_contacts=False`. The rail is
welded to the world at z = 2 and the pole is 1 m long, so no contact
candidate point of the three collision boxes ever comes within a metre of
the ground; their plane rows are inactive in every state and solve to zero
impulse. The JAX task carries the 24 rows through its kernel all the same;
here the model says there are none, and the physics step is the
contact-free instantiation of the fused kernel (nc == 0). The outputs are
the same (tests/test_torch_fused.py holds the step against the JAX step
with and without the rows).
"""
from __future__ import annotations

import math

import torch

from ..envcore.vec_task import VecTask
from ..model import load_urdf
from ..utils.assets import asset_path


class Cartpole(VecTask):
    uses_kin = False

    def __init__(self, cfg, device="cuda"):
        env = cfg.setdefault("env", {})
        self.reset_dist = float(env.get("resetDist", 3.0))
        self.max_push_effort = float(env.get("maxEffort", 400.0))
        env.setdefault("episodeLength", 500)
        self.num_obs = 4
        self.num_acts = 1
        super().__init__(cfg, device)

    def build_model(self):
        asset = self.cfg["env"].get("asset", {}).get("assetFileName", "urdf/cartpole.urdf")
        model = load_urdf(asset_path(asset), fix_base=True)
        body_pos = model.body_pos.copy()
        body_pos[0, 2] = 2.0  # the actor stands at z = 2
        return model.replace(body_pos=body_pos, plane_contacts=False), self.sim_params_from_cfg()

    def sample_init(self, generator, n):
        """positions ~ 0.2 (U - 0.5), velocities ~ 0.5 (U - 0.5) on both dofs."""
        u = lambda: torch.rand(n, 2, generator=generator, device=self.device) - 0.5
        return 0.2 * u(), 0.5 * u(), ()

    def compute_force(self, actions, q, qd, task):
        # effort drive on the cart dof only
        qfrc = torch.zeros(actions.shape[0], self.model.nv, device=actions.device)
        qfrc[:, 0] = actions[:, 0] * self.max_push_effort
        return qfrc, None

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        return torch.stack([q[:, 0], qd[:, 0], q[:, 1], qd[:, 1]], dim=-1)

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        cart_pos, cart_vel, pole_angle, pole_vel = obs.unbind(-1)
        reward = 1.0 - pole_angle * pole_angle - 0.01 * torch.abs(cart_vel) - 0.005 * torch.abs(pole_vel)
        out = (torch.abs(cart_pos) > self.reset_dist) | (torch.abs(pole_angle) > math.pi / 2)
        reward = torch.where(out, torch.full_like(reward, -2.0), reward)
        done = out | (progress >= self.max_episode_length - 1)
        return reward, done, task
