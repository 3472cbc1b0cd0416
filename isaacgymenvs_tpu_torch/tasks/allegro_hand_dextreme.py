"""DeXtreme: AllegroHand in-hand reorientation hardened for sim-to-real
with ADR-driven corruption of actions and observations and a Random
Network Adversary (port of isaacgymenvs_tpu/tasks/allegro_hand_dextreme.py),
batched over envs.

The task is AllegroHand with:
  * ADR parameters per env (`task["adr"]`, drawn by the runtime at every
    reset from the ranges of `EnvState.adr`) scaling the corruption: an
    action latency (a queue `act_hist` of the last 16 raw actions,
    `action_latency` steps back, one more with `action_delay_prob`), affine
    action noise (a per-episode bias and white noise), the RNA's mixing
    coefficient `rna_alpha`, affine noise on the observed joints and cube
    pose, and a simulated camera that refreshes the observed cube pose
    every `cube_pose_refresh_rate` steps unless held (`cube_obs_delay_prob`);
    the physics ADR parameters (`range_path`) steer the DR draws;
  * the policy observation (47): the corrupted joints, camera cube pose,
    goal rotation, their relative rotation and the last actions, in the
    reference's dict-observation keys (`obs_spec`); the asymmetric critic
    takes the clean `full_state` (88);
  * goals drawn as uniform random quaternions (`apply_random_quat`);
  * `actionsMovingAverage` as a schedule dict, annealed from its upper to
    its lower value over `schedule_steps` env steps (`task["_frames"]`);
  * reward terms on the change of the PD targets and on the hand's joint
    velocities; the ADR objective is the consecutive successes.

ManualDR is the same task with its ADR ranges fixed (`update_adr_ranges`
off) and the latency's cap annealed from 0 to `actionLatencyMax` over
`actionLatencyScheduledSteps`.

The JAX task folds each step's corruption draws from a PRNG key in its task
state; the port draws them once per env step from the env state's
generator (`corruption_draws`), and the same draws serve `compute_force`,
the replay of the corruption in `reward_done` (which keeps the targets
consistent with what the physics applied) and `observe` (a declared
difference: the streams differ; tests hand the port JAX's draws).
"""
from __future__ import annotations

import torch

from .. import maths
from ..utils.rna import RandomNetworkAdversary
from .allegro_hand import AllegroHand

ACT_HIST = 16  # the latency queue's depth (covers actionLatencyMax = 15)


class AllegroHandDextremeADR(AllegroHand):
    frames_in_task = True  # the moving average's anneal reads the env-step count

    # the flat policy observation: the reference's dict-observation keys in order
    OBS_SPEC = {
        "dof_pos_randomized": 16,
        "object_pose_cam_randomized": 7,
        "goal_pose": 4,
        "goal_relative_rot_cam_randomized": 4,
        "last_actions": 16,
    }

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        ma = env.get("actionsMovingAverage", 1.0)
        if isinstance(ma, dict):
            lo_up = ma.get("range", [0.15, 0.2])
            self._ma_lower, self._ma_upper = float(lo_up[0]), float(lo_up[1])
            self._ma_steps = float(ma.get("schedule_steps", 1.0))
            env["actionsMovingAverage"] = self._ma_upper
        else:
            self._ma_lower = self._ma_upper = float(ma)
            self._ma_steps = 1.0
        env.setdefault("observationType", "no_vel")
        env.setdefault("asymmetric_observations", True)
        env.setdefault("maxConsecutiveSuccesses", 50)
        self.action_delta_penalty_scale = float(env.get("actionDeltaPenaltyScale", -0.2))
        self.apply_random_quat = bool(env.get("apply_random_quat", True))
        self.num_success_hold_steps = int(env.get("num_success_hold_steps", 1))
        super().__init__(cfg, device)
        self.num_obs, self.num_states, self.num_acts = 47, 88, 16
        if self.adr is None:
            raise ValueError("AllegroHandDextremeADR needs an `adr:` cfg block with use_adr: true "
                             "(cfg/task/AllegroHandDextremeADR.yaml)")
        self._ai = {n: i for i, n in enumerate(self.adr.param_names())}
        self.rna = RandomNetworkAdversary(in_dim=23, num_actions=16, seed=int(self.cfg.get("seed", 0) or 0),
                                          device=self.device)
        self._draws = None  # the corruption draws of the step (or reset) in progress

    def obs_spec(self):
        out, off = {}, 0
        for k, n in self.OBS_SPEC.items():
            out[k] = (off, n)
            off += n
        return out

    # ---- schedules --------------------------------------------------------
    def _latency_cap(self, task):
        """The latency draw's upper clamp: the queue's depth."""
        return ACT_HIST - 1

    def _act_ma(self, task):
        t = task.get("_frames")
        if t is None or self._ma_lower == self._ma_upper:
            return self.act_moving_average
        frac = torch.clamp(t.to(torch.float32) / self._ma_steps, max=1.0)
        return self._ma_upper + (self._ma_lower - self._ma_upper) * frac

    def _a(self, task, name, default=0.0):
        """(n,) the envs' ADR parameter `name` (`default` where the cfg has none)."""
        i = self._ai.get(name)
        if i is None:
            return torch.full((task["adr"].shape[0],), default, device=self.device)
        return task["adr"][:, i]

    def adr_objective(self, task):
        """The consecutive successes, the reference's ADR objective."""
        return task["successes"]

    # ---- draws ------------------------------------------------------------
    def _rotation(self, u):
        """Uniform random quaternions from standard normal draws u (n, 4);
        two-angle draws (n, 2) as AllegroHand takes them."""
        if u.shape[-1] == 2:
            return super()._rotation(u)
        return u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)

    def _rot_draws(self, generator, n):
        if self.apply_random_quat:
            return torch.randn(n, 4, generator=generator, device=self.device)
        return torch.rand(n, 2, generator=generator, device=self.device) * 2 - 1

    def init_from_draws(self, dof_u, vel_u, pos_u, rot_u, goal_u, prob_u, bias_action_u=None, bias_dof_u=None,
                        bias_cube_u=None, rna_mask=None):
        """AllegroHand's init states from the same draws (rotations from
        normal (n, 4) draws with `apply_random_quat`) and the corruption's
        per-episode state: the unit biases (n, 16), (n, 16), (n, 7)
        (standard normal; zero where not given), the RNA's masks (n, 2, 64)
        (all kept where not given), an empty latency queue and the camera
        latched on the initial cube pose."""
        q, qd, task = super().init_from_draws(dof_u, vel_u, pos_u, rot_u, goal_u, prob_u)
        n, dev, oq = q.shape[0], self.device, self.obj_q
        z = lambda *s: torch.zeros(*s, device=dev)
        task.update(
            adr=z(n, self.adr.P),  # drawn by the runtime at every reset
            act_hist=z(n, ACT_HIST, 16),
            bias_action_u=z(n, 16) if bias_action_u is None else bias_action_u,
            bias_dof_u=z(n, 16) if bias_dof_u is None else bias_dof_u,
            bias_cube_u=z(n, 7) if bias_cube_u is None else bias_cube_u,
            rna_mask=self.rna.mask_from_draws(z(n, 2, self.rna.hidden)) if rna_mask is None else rna_mask,
            cube_obs=q[:, oq:oq + 7].clone(),
            cube_age=torch.zeros(n, dtype=torch.int32, device=dev),
        )
        return q, qd, task

    def sample_init(self, generator, n):
        self._rng = generator  # the env state's generator, which the reset's observation draws from
        dev, nh = self.device, self.num_hand_dofs
        u = lambda *shape: torch.rand(*shape, generator=generator, device=dev) * 2 - 1
        normal = lambda *shape: torch.randn(*shape, generator=generator, device=dev)
        return self.init_from_draws(u(n, nh), u(n, nh), u(n, 3), self._rot_draws(generator, n),
                                    self._rot_draws(generator, n), torch.rand(n, generator=generator, device=dev),
                                    normal(n, 16), normal(n, 16), normal(n, 7), self.rna.sample_mask(generator, n))

    def draws_of_step(self, n):
        """The draws of one step's reward: the new goals' (normal (n, 4)
        with `apply_random_quat`), the kicks' (n,) uniform and the kick
        forces' (n, 3) standard normal."""
        g, dev = self._rng, self.device
        return (self._rot_draws(g, n), torch.rand(n, generator=g, device=dev),
                torch.randn(n, 3, generator=g, device=dev))

    def corruption_draws(self, n):
        """The corruption's draws of one env step, from the stepped state's
        generator: `delay_u` (n,) and `hold_u` (n,) uniform in [0, 1) for
        the extra latency step and the camera hold, and standard normal
        white noise `act_white` (n, 16), `dof_white` (n, 16), `cube_white`
        (n, 7)."""
        g, dev = self._rng, self.device
        return {"delay_u": torch.rand(n, generator=g, device=dev),
                "act_white": torch.randn(n, 16, generator=g, device=dev),
                "dof_white": torch.randn(n, 16, generator=g, device=dev),
                "cube_white": torch.randn(n, 7, generator=g, device=dev),
                "hold_u": torch.rand(n, generator=g, device=dev)}

    def reset(self, seed: int = 0):
        self._draws = None  # the reset's observation draws its own
        return super().reset(seed)

    def step(self, state, actions):
        self._rng = state.rng
        self._draws = self.corruption_draws(self.num_envs)
        return super().step(state, actions)

    # ---- action corruption: latency, then affine noise, then the RNA --------
    def _corrupt_action(self, action, q, task, d):
        n = action.shape[0]
        lat = torch.floor(self._a(task, "action_latency")).to(torch.int64)
        lat = lat + (d["delay_u"] < torch.clamp(self._a(task, "action_delay_prob"), 0.0, 1.0)).to(torch.int64)
        cap = self._latency_cap(task)  # an int, or a 0-d tensor on the device (no copy from the host per step)
        lat = torch.clamp(lat, 0, cap) if isinstance(cap, int) else torch.minimum(torch.clamp(lat, min=0), cap)
        stream = torch.cat([action[:, None], task["act_hist"][:, :-1]], 1)  # stream[:, 0] = a_t
        a = stream[torch.arange(n, device=self.device), lat]
        a = (a + self._a(task, "affine_action_additive")[:, None] * task["bias_action_u"]
             + self._a(task, "affine_action_white")[:, None] * d["act_white"])
        oq = self.obj_q
        a_rna = self.rna(task["rna_mask"], torch.cat([q[:, self.hand_q_idx], q[:, oq:oq + 7]], -1))
        alpha = torch.clamp(self._a(task, "rna_alpha"), 0.0, 1.0)[:, None]
        return torch.clamp((1.0 - alpha) * a + alpha * a_rna, -1.0, 1.0)

    def compute_force(self, actions, q, qd, task):
        return super().compute_force(self._corrupt_action(actions, q, task, self._draws), q, qd, task)

    # ---- observations -------------------------------------------------------
    def observe(self, q, qd, kin, sensors, task, actions, progress):
        """The corrupted policy view (the reference's `_randomized` keys)."""
        if self._draws is None:  # a reset's observation
            self._draws = self.corruption_draws(q.shape[0])
        d = self._draws
        dof = maths.unscale(q[:, self.hand_q_idx], self.dof_lower, self.dof_upper)
        dof = (dof + self._a(task, "affine_dof_pos_additive")[:, None] * task["bias_dof_u"]
               + self._a(task, "affine_dof_pos_white")[:, None] * d["dof_white"])
        cube = (task["cube_obs"] + self._a(task, "affine_cube_pose_additive")[:, None] * task["bias_cube_u"]
                + self._a(task, "affine_cube_pose_white")[:, None] * d["cube_white"])
        goal_rot = task["goal_rot"]
        quat_diff = maths.quat_mul(cube[:, 3:7], maths.quat_conjugate(goal_rot))
        return torch.cat([dof, cube, goal_rot, quat_diff, actions], -1)

    def observe_state(self, q, qd, kin, sensors, task, actions, progress):
        """The clean full state for the asymmetric critic."""
        return self._obs_impl(q, qd, kin, sensors, task, actions, "full_state")

    # ---- reward and the carried corruption state -----------------------------
    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        reward, done, new_task = super().reward_done(obs, q, qd, kin, sensors, task, actions, progress)
        d = self._draws
        # the physics took the corrupted action: the targets follow it
        new_task["targets"] = self._targets(task["targets"], self._corrupt_action(actions, q, task, d), task,
                                            capped=True)
        # the smoothness penalty on the targets' change, and the hand's joint velocities
        reward = reward + self.action_delta_penalty_scale * torch.sum((new_task["targets"] - task["targets"]) ** 2, -1)
        reward = reward - 0.05 * torch.sum((qd[:, self.hand_v_idx] / 4.0) ** 2, -1)
        new_task["act_hist"] = torch.cat([actions[:, None], task["act_hist"][:, :-1]], 1)
        # the simulated camera holds the cube pose for cube_pose_refresh_rate steps, or longer when held
        age = task["cube_age"] + 1
        rate = torch.floor(torch.clamp(self._a(task, "cube_pose_refresh_rate", 1.0), min=1.0)).to(age.dtype)
        hold = d["hold_u"] < torch.clamp(self._a(task, "cube_obs_delay_prob"), 0.0, 1.0)
        refresh = (age >= rate) & ~hold
        oq = self.obj_q
        new_task["cube_obs"] = torch.where(refresh[:, None], q[:, oq:oq + 7], task["cube_obs"])
        new_task["cube_age"] = torch.where(refresh, torch.zeros_like(age), age)
        for k in ("adr", "bias_action_u", "bias_dof_u", "bias_cube_u", "rna_mask"):
            new_task[k] = task[k]
        return reward, done, new_task


class AllegroHandDextremeManualDR(AllegroHandDextremeADR):
    """The same corruption with fixed ranges: ADR's sampler without range
    updates, and the latency's cap annealed over the run."""

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self._lat_max = float(env.get("actionLatencyMax", 15))
        self._lat_sched = float(env.get("actionLatencyScheduledSteps", 10_000_000))
        adr_cfg = env.get("adr") or cfg.get("adr") or {}
        adr_cfg["use_adr"] = True  # the sampler's machinery
        adr_cfg["update_adr_ranges"] = False
        env["adr"] = adr_cfg
        super().__init__(cfg, device)

    def _latency_cap(self, task):
        t = task.get("_frames")
        if t is None or self._lat_sched <= 0:
            return ACT_HIST - 1
        cur = torch.floor(self._lat_max * torch.clamp(t.to(torch.float32) / self._lat_sched, max=1.0))
        return torch.clamp(cur.to(torch.int64), max=ACT_HIST - 1)
