"""AnymalTerrain: rough-terrain locomotion with a terrain curriculum (port
of isaacgymenvs_tpu/tasks/anymal_terrain.py), batched over envs.

The ground is a procedural heightfield (`utils.terrain_utils.TerrainGrid`:
levels of growing difficulty by terrain types), which the physics samples
under each candidate point (`engine.dynamics.Terrain`). The 188-dim
observation adds a 140-point height scan around the base, turned with its
heading; the reward has 13 terms (summed per episode in `episode_sums`);
robots are pushed at random every `pushInterval_s`; an env that ends its
episode moves up a level when it walked more than half a terrain cell and
down one when it walked less than a quarter of its command's distance, and
respawns on its level. The `learn:` block's observation noise and surface
friction draw become domain-randomization specs (per-key additive noise, a
setup-only friction factor per env).

Declared differences from the JAX task: the pushes and the spawn points are
drawn from the port's generator, not from the JAX PRNG streams.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import maths
from ..engine.dynamics import Terrain
from ..utils.terrain_utils import TerrainGrid
from .anymal import Anymal

# the spawn probes: the ground under the footprint, the highest of nine points
_PROBE = [(dx, dy) for dx in (-0.5, 0.0, 0.5) for dy in (-0.35, 0.0, 0.35)]


class AnymalTerrain(Anymal):
    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        t = env.get("terrain", {})
        self.terrain_type = str(t.get("terrainType", "trimesh"))
        self.curriculum = bool(t.get("curriculum", True))
        self.num_levels = int(t.get("numLevels", 10))
        self.num_types = int(t.get("numTerrains", 20))
        self.horizontal_scale = float(t.get("horizontalScale", 0.1)) or 0.1
        learn = env.get("learn", {})
        self.height_meas_scale = float(learn.get("heightMeasurementScale", 5.0))
        self.rew_scales_extra = {
            "lin_vel_z": float(learn.get("linearVelocityZRewardScale", -4.0)),
            "ang_vel_xy": float(learn.get("angularVelocityXYRewardScale", -0.05)),
            "orient": float(learn.get("orientationRewardScale", 0.0)),
            "base_height": float(learn.get("baseHeightRewardScale", 0.0)),
            "joint_acc": float(learn.get("jointAccRewardScale", -0.0005)),
            "collision": float(learn.get("kneeCollisionRewardScale", -0.25)),
            "stumble": float(learn.get("feetStumbleRewardScale", -2.0)),
            "action_rate": float(learn.get("actionRateRewardScale", -0.01)),
            "air_time": float(learn.get("feetAirTimeRewardScale", 1.0)),
            "hip": float(learn.get("hipRewardScale", 0.0)),
            "termination": float(learn.get("terminalReward", 0.0)),
        }
        self.allow_knee_contacts = bool(learn.get("allowKneeContacts", True))
        self.push_robots = bool(learn.get("pushRobots", True))
        decimation = int(env.get("control", {}).get("decimation", 4))
        self.push_interval = int(
            float(learn.get("pushInterval_s", 15.0)) / (float(cfg.get("sim", {}).get("dt", 0.005)) * decimation) + 0.5)
        env.setdefault("controlFrequencyInv", decimation)
        self._inject_learn_noise(cfg, learn)
        super().__init__(cfg, device)
        self.num_obs = 188

        # the height scan: 14 x 10 points around the base (reference :503-513)
        gx = 0.1 * np.array([-8, -7, -6, -5, -4, -3, -2, 2, 3, 4, 5, 6, 7, 8])
        gy = 0.1 * np.array([-5, -4, -3, -2, -1, 1, 2, 3, 4, 5])
        pts = np.stack(np.meshgrid(gx, gy, indexing="ij"), -1).reshape(-1, 2)
        self.num_height_points = len(pts)
        self.height_points = torch.as_tensor(
            np.concatenate([pts, np.zeros((len(pts), 1))], -1), dtype=torch.float32, device=self.device)
        # the window the scan reads: its extent around the base at any yaw,
        # plus the bilinear support, in multiples of 8 cells (as the JAX task)
        p = int(np.ceil(2.0 * float(np.max(np.linalg.norm(pts, axis=1))) / self.horizontal_scale)) + 4
        self._scan_patch = ((p + 7) // 8) * 8
        m = self.model
        self.feet_bodies = torch.as_tensor([i for i, n in enumerate(m.body_names) if "SHANK" in n], device=self.device)
        self.max_episode_length_s = float(env.get("learn", {}).get("episodeLength_s", 20.0))
        self.hip_dofs = torch.as_tensor([0, 3, 6, 9], device=self.device)
        self.probe = torch.tensor(_PROBE, dtype=torch.float32, device=self.device)
        self.zero3 = torch.zeros(3, device=self.device)

    def build_model(self):
        model, params = super().build_model()
        self.grid, self.terrain_origins = None, None
        if self.terrain_type not in ("plane", "none"):
            self.grid = TerrainGrid(num_levels=self.num_levels, num_terrains=self.num_types,
                                    horizontal_scale=self.horizontal_scale, curriculum=self.curriculum)
            self.terrain = Terrain(torch.as_tensor(self.grid.height, device=self.device), self.grid.hs)
            self.terrain_origins = torch.as_tensor(self.grid.env_origins, device=self.device)
        return model, params

    @staticmethod
    def _inject_learn_noise(cfg, learn):
        """The reference's additive observation noise vector and its static
        per-env surface friction as domain-randomization specs: noise
        uniform in [-s, s] per observation key, a setup-only friction
        factor (the base friction is 1, so a factor over the range is the
        reference's absolute draw)."""
        task_cfg = cfg.get("task") or {}
        params = task_cfg.get("randomization_params") or {}
        if learn.get("addNoise", True):
            nl = float(learn.get("noiseLevel", 1.0))
            svec = {
                "base_lin_vel": nl * float(learn.get("linearVelocityNoise", 0.1))
                * float(learn.get("linearVelocityScale", 2.0)),
                "base_ang_vel": nl * float(learn.get("angularVelocityNoise", 0.2))
                * float(learn.get("angularVelocityScale", 0.25)),
                "gravity": nl * float(learn.get("gravityNoise", 0.05)),
                "dof_pos": nl * float(learn.get("dofPositionNoise", 0.01)) * float(learn.get("dofPositionScale", 1.0)),
                "dof_vel": nl * float(learn.get("dofVelocityNoise", 1.5)) * float(learn.get("dofVelocityScale", 0.05)),
                "heights": nl * float(learn.get("heightMeasurementNoise", 0.06))
                * float(learn.get("heightMeasurementScale", 5.0)),
            }
            obs = dict(params.get("observations") or {})
            for k, sc in svec.items():
                if sc != 0.0:
                    obs.setdefault(k, {"range": [-sc, sc], "operation": "additive", "distribution": "uniform"})
            params["observations"] = obs
        if learn.get("randomizeFriction", True):
            lo, hi = learn.get("frictionRange", [0.5, 1.25])
            rs = params.setdefault("actor_params", {}).setdefault("anymal", {}).setdefault("rigid_shape_properties", {})
            rs.setdefault("friction", {"range": [float(lo), float(hi)], "operation": "scaling",
                                       "distribution": "uniform", "setup_only": True})
        if params:
            task_cfg["randomization_params"] = params
            task_cfg["randomize"] = True
            cfg["task"] = task_cfg

    def obs_spec(self):
        """{key: (offset, size)} slices of the 188-dim observation."""
        return {
            "base_lin_vel": (0, 3),
            "base_ang_vel": (3, 3),
            "gravity": (6, 3),
            "commands": (9, 3),
            "dof_pos": (12, 12),
            "dof_vel": (24, 12),
            "heights": (36, self.num_height_points),
            "actions": (36 + self.num_height_points, 12),
        }

    def perturb_state(self, generator, q, qd, frames, task):
        """Robot pushes: every push_interval env steps the base's xy
        velocity becomes a U[-1, 1] draw."""
        if not self.push_robots or self.push_interval <= 0:
            return q, qd
        v = -1.0 + 2.0 * torch.rand(q.shape[0], 2, generator=generator, device=q.device)
        push = (frames > 0) & (frames % self.push_interval == 0)
        qd = qd.clone()
        qd[:, 0:2] = torch.where(push, v, qd[:, 0:2])
        return q, qd

    # ---- init / reset with the terrain curriculum ---------------------
    def sample_init(self, generator, n, level=None, ttype=None):
        q, qd, commands = super().sample_init(generator, n)
        dev = self.device
        if self.terrain_origins is not None:
            if level is None:
                max_init = self.num_levels if not self.curriculum else max(1, self.num_levels // 2)
                level = torch.randint(0, max_init, (n,), generator=generator, device=dev)
            if ttype is None:
                ttype = torch.randint(0, self.num_types, (n,), generator=generator, device=dev)
            origin = self.terrain_origins[level, ttype]
            xy = origin[:, 0:2] - 0.5 + torch.rand(n, 2, generator=generator, device=dev)
            q[:, 0:2] = xy
            # spawn on the local ground: the highest of the probes under the footprint
            ground = torch.amax(self.terrain.sample(xy[:, None] + self.probe), dim=1)
            q[:, 2] = q[:, 2] + ground
        else:
            level = torch.zeros(n, dtype=torch.int64, device=dev)
            ttype = torch.zeros(n, dtype=torch.int64, device=dev)
            origin = self.zero3.expand(n, 3)
        zeros = lambda k: torch.zeros(n, k, device=dev)
        task = {
            "commands": commands,
            "level": level,
            "type": ttype,
            "origin": origin,
            "last_actions": zeros(12),
            "last_dof_vel": zeros(12),
            "feet_air_time": zeros(len(self.feet_bodies)),
            "ep_sums": zeros(13),
        }
        return q, qd, task

    def resample_init(self, generator, old_task):
        """Respawn on the level the episode ended with, on the same terrain type."""
        return self.sample_init(generator, self.num_envs, level=old_task["level"], ttype=old_task["type"])

    def compute_force(self, actions, q, qd, task):
        return super().compute_force(actions, q, qd, task["commands"])

    # ---- observations --------------------------------------------------
    def _heights_at(self, q):
        """The height scan, turned with the base's heading."""
        if self.terrain is None:
            return torch.zeros(q.shape[0], self.num_height_points, device=q.device)
        yaw = maths.calc_heading_quat(q[:, 3:7])
        world = maths.quat_rotate(yaw[:, None], self.height_points)[..., :2] + q[:, None, 0:2]
        return self.terrain.sample_patch(q[:, 0:2], world, P=self._scan_patch)

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        lin, ang, grav = self._base_frame(q, qd)
        heights = torch.clamp(q[:, 2:3] - 0.5 - self._heights_at(q), -1.0, 1.0) * self.height_meas_scale
        return torch.cat([
            lin * self.lin_vel_scale,
            ang * self.ang_vel_scale,
            grav,
            task["commands"] * self.cmd_scale,
            (q[:, self.dof_q_idx] - self.default_dof_pos) * self.dof_pos_scale,
            qd[:, self.dof_idx] * self.dof_vel_scale,
            heights,
            actions,
        ], dim=-1)

    # ---- reward: 13 terms, and the curriculum ---------------------------
    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        commands = task["commands"]
        lin, ang, grav = self._base_frame(q, qd)
        rs = self.rew_scales_extra
        sq = lambda x: torch.sum(torch.square(x), dim=-1)
        r_lin, r_ang = self._tracking(commands, lin, ang)
        r_linz = torch.square(lin[:, 2]) * rs["lin_vel_z"]
        r_angxy = sq(ang[:, :2]) * rs["ang_vel_xy"]
        r_orient = sq(grav[:, :2]) * rs["orient"]
        ground = self.terrain.sample(q[:, 0:2]) if self.terrain is not None else 0.0
        r_height = torch.square(q[:, 2] - ground - 0.52) * rs["base_height"]
        r_torque = sq(self._pd_torques(q, qd, actions)) * self.rew_torque_scale
        dof_vel = qd[:, self.dof_idx]
        r_acc = sq(task["last_dof_vel"] - dof_vel) * rs["joint_acc"]
        knee_force = torch.linalg.vector_norm(sensors.body_force[:, self.knee_bodies], dim=-1)
        r_coll = torch.sum((knee_force > 1.0).to(q.dtype), dim=-1) * rs["collision"]
        feet_f = sensors.body_force[:, self.feet_bodies]
        stumble = (torch.linalg.vector_norm(feet_f[..., :2], dim=-1) > 5.0) & (torch.abs(feet_f[..., 2]) < 1.0)
        r_stumble = torch.sum(stumble.to(q.dtype), dim=-1) * rs["stumble"]
        r_act_rate = sq(task["last_actions"] - actions) * rs["action_rate"]
        # feet air time, paid at the first contact after a swing
        contact = feet_f[..., 2] > 1.0
        air = task["feet_air_time"]
        first_contact = ((air > 0.0) & contact).to(q.dtype)
        air = air + self.dt
        r_air = torch.sum((air - 0.5) * first_contact, dim=-1) * rs["air_time"]
        r_air = r_air * (torch.linalg.vector_norm(commands[:, :2], dim=-1) > 0.1).to(q.dtype)
        air = air * (~contact).to(q.dtype)
        hip_pos = q[:, self.dof_q_idx][:, self.hip_dofs]
        r_hip = torch.sum(torch.abs(hip_pos - self.default_dof_pos[self.hip_dofs]), dim=-1) * rs["hip"]
        terms = torch.stack([r_lin, r_ang, r_linz, r_angxy, r_orient, r_height, r_torque,
                             r_acc, r_coll, r_act_rate, r_air, r_hip, r_stumble], dim=-1)
        total = torch.clamp(torch.sum(terms, dim=-1), min=0.0)

        base_hit = torch.linalg.vector_norm(sensors.body_force[:, self.base_body], dim=-1) > 1.0
        knee_hit = torch.any(knee_force > 1.0, dim=-1) & (not self.allow_knee_contacts)
        timeout = progress >= self.max_episode_length - 1
        done = base_hit | knee_hit | timeout
        total = total + rs["termination"] * (done & ~timeout).to(q.dtype)

        # the curriculum at the episode's end: up a level after walking more
        # than half a cell, down one after less than a quarter of the command
        level = task["level"]
        if self.terrain_origins is not None and self.curriculum:
            dist = torch.linalg.vector_norm(q[:, 0:2] - task["origin"][:, 0:2], dim=-1)
            demote = dist < torch.linalg.vector_norm(commands[:, :2], dim=-1) * self.max_episode_length_s * 0.25
            promote = dist > self.grid.env_length / 2
            new_level = torch.clamp(level - demote.long() + promote.long(), 0, self.num_levels - 1)
            level = torch.where(done, new_level, level)

        new_task = {
            "commands": commands,
            "level": level,
            "type": task["type"],
            "origin": task["origin"],
            "last_actions": actions,
            "last_dof_vel": dof_vel,
            "feet_air_time": air,
            "ep_sums": task["ep_sums"] + terms,
        }
        return total, done, new_task

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        """The per-term episode reward sums and the terrain level."""
        return {"episode_sums": task["ep_sums"], "terrain_level": task["level"].to(torch.float32)}
