"""Vectorized task runtime (port of isaacgymenvs_tpu/envcore/vec_task.py).

An environment is a `VecTask` subclass that supplies batched hooks; the
env batch is the leading axis of every tensor. `reset` and `step` keep the
JAX package's ordering contract:
  1. (action noise, then) clip actions, apply them, advance physics
     `control_freq_inv` times; a task's `perturb_state` (robot pushes) then
     acts on the new state;
  2. progress += 1;
  3. envs flagged done on the PREVIOUS step are reset (fresh init states
     for every env from `resample_init`, selected with a where over the
     done mask; a task with `costly_reset` draws them only in a step where
     some env resets);
  3b. with domain randomization: envs that reset and whose last
     randomization is `frequency` steps old take a fresh sample
     (`setup_only` leaves never), branch-free;
  4. observations on the post-reset state (then observation noise);
  5. reward and new done flags, then the task's `extra_outputs` (5a), then
     its `population_update` (5b, only where a task overrides it): a
     full-batch change of the task state from statistics across envs (the
     SBC curriculum of IndustReal), so the extras carry the values from
     before it;
  6. `time_outs` = progress >= max_episode_length - 1 AND done.

Physics takes one of two routes, chosen once per env (`physics_route`, read
at the latest by the first reset, since a task may set `self.terrain` after
`VecTask.__init__`) and printed once:
  * "kernel": `engine.fused.physics_step_fused`, the hand-written kernel on
    a CUDA tensor and its plain version on a CPU tensor. It is taken where
    the kernel covers the model (`fused.unsupported_features` is empty),
    every per-env leaf of domain randomization is one the kernel takes
    (`DYN_LEAVES` or `DYN_INERT`), per-env candidate points do not meet
    terrain or SDF rows (their planes are sampled at the model's own
    points), and `sim.use_fused` is not False;
  * "eager": `engine.step.physics_step`, the eager engine, on the env's
    device: for `sim.use_fused: False` and every model or sample the kernel
    does not cover. Its per-env leaves are the sample's leaves in their model
    layout (`EnvState.dyn` a dict), and it samples the terrain and SDF grids
    at every slice.
`sim.use_fused: True` on a model the kernel does not cover raises
NotImplementedError naming what it lacks (the JAX package takes its eager
engine there), and a kernel that fails to build or launch raises: the route
never changes on a failure. A task with `use_pd_targets` also returns PD-drive
setpoints, which every physics step of the control loop receives. A task
with a heightfield (`self.terrain`, an `engine.dynamics.Terrain`) has each
step's ground planes sampled under its candidate points at the step's entry
pose (`fused.terrain_dyn`); a model with SDF pair rows (candidate points
against voxel SDF grids) likewise has each step's SDF contact planes sampled
at the step's entry pose (`fused.sdf_dyn`). With
`sim.fused_merge_control_slices`, on the kernel route, the `control_freq_inv`
physics steps of an env step are one call of `control_freq_inv` times the slices (dt and
substeps scaled together, so the slice length stays), whose warm start
resets where each separate call would begin; the terrain and SDF planes are
then sampled once, at the env step's entry pose.

With `task.randomize` the env carries a `dr.DomainRandomizer`: its sample
lives on the state (`EnvState.dr`), and the per-env model leaves and
gravity it gives are made once where the sample changes (`EnvState.dyn`:
packed for the kernel, a dict of leaves for the eager engine) and handed to
every physics step.

With an `adr:` block that sets `use_adr` the env carries a `dr.ADR`, its
population state on `EnvState.adr`: the reset draws the initial state, and
every reset (full or partial) draws the resetting envs' ADR parameters
(`task["adr"]`, (N, P)) from the current ranges; the DR draws take the
ranges ADR evolves for the specs it names (`dr_overrides`); after the
reward (6b) the boundary workers that finished push the task's
`adr_objective` and full queues move their edges; `extras["adr_nats"]`
carries the range entropy. A task with `frames_in_task` sees the env-step
count as `task["_frames"]` in its hooks (the count before the step in
`compute_force`, after it in `observe` and `reward_done`); it is not kept
in the state.

Under a process group (`parallel/distributed.py`) the env holds the rank's
block of the yaml's `numEnvs` (`global_num_envs`): `num_envs` is the
block's size and `env_block` its slice. The state's generator draws a
stream of the rank's own (the seed folded with the rank); ADR's population
is global and its worker assignments come from `shared_rng`, the same
stream on every rank (in one process the state's generator itself). A
task's `population_update` reads statistics across the envs and is not
ported across ranks: such a task raises there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..engine import dynamics as _dyn
from ..engine import fused as _fused
from ..engine import step as _step
from ..engine.dynamics import SimParams, SimState
from ..model.spec import Model
from ..parallel import distributed, sharding


_ROUTES_SHOWN: set = set()  # the route lines printed in this process


class Sensors(NamedTuple):
    """Per-env sensor readings of the physics step."""

    body_force: torch.Tensor  # (N, nbody, 3) contact force per body (world)
    body_torque: torch.Tensor  # (N, nbody, 3) contact torque about body origin
    dof_force: torch.Tensor  # (N, nv) generalized contact force


@dataclasses.dataclass
class EnvState:
    """Batched environment state: everything that evolves across steps."""

    sim: SimState  # q (N, nq), qd (N, nv)
    progress: torch.Tensor  # (N,) int32, steps since reset
    reset_buf: torch.Tensor  # (N,) bool, done flags from the last step
    rng: torch.Generator  # draws the init states of partial resets
    actions: torch.Tensor  # (N, num_acts) last applied actions
    task: Any = None  # task-specific tensors (potentials, ...)
    # domain randomization (None when task.randomize is off):
    dr: Any = None  # dict name -> (N, ...) sampled factors/offsets
    dyn: Any = None  # the per-env leaves of `dr` as the route's step takes them: fused.PackedDyn, or a dict
    randomize_buf: Any = None  # (N,) int32, steps since the last re-randomization
    frames: Any = None  # () int32, env steps since reset (DR schedules, pushes)
    adr: Any = None  # dr.AdrState: ADR's ranges, queues and worker assignment (None without ADR)
    shared_rng: Any = None  # draws alike on every rank (ADR's worker assignments); `rng` in one process


def _select(mask: torch.Tensor, a, b):
    """where(mask, a, b) over a tensor or a tuple/dict of tensors."""
    if isinstance(a, tuple):
        return tuple(_select(mask, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return {k: _select(mask, a[k], b[k]) for k in a}
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


class VecTask:
    """Base class: subclasses define the model and the batched hooks.

    Hooks (batched over envs, env-leading tensors):
      build_model() -> (Model, SimParams)                     [host, once]
      sample_init(generator, n) -> (q, qd, task)
      compute_force(actions, q, qd, task) -> (qfrc, xfrc)
          or, with use_pd_targets, (qfrc, xfrc, q_target)
      observe(q, qd, kin, sensors, task, actions, progress) -> obs
      reward_done(obs, q, qd, kin, sensors, task, actions, progress)
          -> (reward, done, new_task)
    Optional hooks (the defaults change nothing):
      perturb_state(generator, q, qd, frames, task) -> (q, qd)
      resample_init(generator, old_task) -> (q, qd, task) of the resets
      extra_outputs(q, qd, kin, sensors, task, actions, progress) -> dict
      population_update(task, done, progress) -> task
    """

    num_obs: int = 0
    num_acts: int = 0
    # privileged state of an asymmetric critic (observe_state); 0: none
    num_states: int = 0
    # False when the hooks never read `kin`: step then skips the forward
    # kinematics pass, as XLA drops it from the JAX package's jitted step
    uses_kin: bool = True
    # True when compute_force also returns q_target, an (N, nq) vector of
    # PD-drive setpoints that the physics re-evaluates every slice
    use_pd_targets: bool = False
    # True when resample_init is costly (IndustReal's 24 IK iterations,
    # five in six of its step's device ops): the step then calls it only
    # when some env resets, which waits for the device once per step; the
    # others draw every step and select, branch-free
    costly_reset: bool = False
    # True when the hooks read the env-step count as task["_frames"]
    frames_in_task: bool = False

    def __init__(self, cfg: Dict[str, Any], device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        env_cfg = cfg.get("env", {})
        self.global_num_envs = int(env_cfg.get("numEnvs", 64))
        self.env_block = sharding.env_block(self.global_num_envs)  # the rank's envs
        self.num_envs = self.env_block.stop - self.env_block.start
        if distributed.process_count() > 1 and type(self).population_update is not VecTask.population_update:
            raise NotImplementedError(f"{type(self).__name__}.population_update (statistics across the envs) "
                                      "is not ported across the ranks of a process group")
        self.max_episode_length = int(env_cfg.get("episodeLength", 500))
        self.clip_obs = float(env_cfg.get("clipObservations", np.inf))
        self.clip_actions = float(env_cfg.get("clipActions", np.inf))
        self.control_freq_inv = int(env_cfg.get("controlFrequencyInv", 1))
        self.terrain = None
        self.model, self.sim_params = self.build_model()
        task_cfg = cfg.get("task", {}) or {}
        sim_cfg = cfg.get("sim", {}) or {}
        p = self.sim_params
        self.use_fused = sim_cfg.get("use_fused", "auto")
        if self.use_fused not in (True, False, "auto"):
            raise ValueError(f"sim.use_fused is True, False or auto, not {self.use_fused!r}")
        self._route = None
        self.merge_slices = bool(sim_cfg.get("fused_merge_control_slices")) and self.control_freq_inv > 1
        # the merged window: one call of control_freq_inv x the slices, each as long as before
        self._merged_params = dataclasses.replace(
            p, dt=p.dt * self.control_freq_inv, substeps=p.substeps * self.control_freq_inv)
        self._warm_reset_every = p.substeps * p.solver_iterations if self.merge_slices else 0
        self.randomizer = None
        if task_cfg.get("randomize"):
            from ..dr.randomize import DomainRandomizer

            self.randomizer = DomainRandomizer(
                self.model,
                task_cfg.get("randomization_params", {}),
                actor_ranges=self.dr_actor_ranges(),
                obs_dim=lambda: self.num_obs,
                act_dim=lambda: self.num_acts,
                obs_slices=lambda: self.obs_spec() if hasattr(self, "obs_spec") else None,
                device=self.device,
            )
            self._setup_only = {s.name for s in self.randomizer.model_specs if s.setup_only}
        self.adr = None
        self.adr_load_from_checkpoint = False
        adr_cfg = env_cfg.get("adr") or cfg.get("adr")
        if adr_cfg and adr_cfg.get("use_adr"):
            from ..dr.adr import ADR

            self.adr = ADR(adr_cfg, self.global_num_envs, self.device, block=self.env_block)
            # a checkpoint's ADR state is restored only where the cfg asks for it
            self.adr_load_from_checkpoint = bool(adr_cfg.get("adr_load_from_checkpoint", False))
        # the env-step counter on the state: DR schedules, perturb_state and frames_in_task read it
        self._counts_frames = (self.randomizer is not None or self.frames_in_task
                               or type(self).perturb_state is not VecTask.perturb_state)
        self.total_train_env_frames = 0
        self.dt = self.sim_params.dt * self.control_freq_inv
        # model constants the step reads, kept on the device: a copy from
        # host memory inside the step would wait for the card every step
        m = self.model
        self._act_dof = torch.as_tensor(np.asarray(m.actuator_dof, np.int64), device=self.device)
        self._gear = torch.as_tensor(np.asarray(m.gear, np.float32), device=self.device)

    # ---- the physics route --------------------------------------------
    def kernel_refusals(self) -> list:
        """What keeps this env off the kernel, by name: the model's features
        beyond the kernel (`fused.unsupported_features`) and the per-env
        leaves of its domain randomization that the kernel does not take."""
        out = list(_fused.unsupported_features(self.model, self.sim_params, self.terrain))
        if self.randomizer is not None:
            batched = self.randomizer.batched_leaf_names()
            beyond = sorted(batched - set(_fused.DYN_LEAVES) - set(_fused.DYN_INERT))
            if beyond:
                out.append("per-env leaves the kernel does not take: " + ", ".join(beyond))
            if "cpoint_pos" in batched and (self.terrain is not None or len(self.model.spair_point)):
                # the kernel's terrain and SDF planes are sampled at the model's own candidate points
                out.append("per-env cpoint_pos (actor scale) with terrain or SDF rows")
        return out

    @property
    def physics_route(self) -> str:
        """"kernel" or "eager" (see the module docstring), decided the first
        time it is read and printed once per process and reason."""
        if self._route is None:
            refused = self.kernel_refusals()
            if self.use_fused is True and refused:
                raise NotImplementedError(f"{type(self).__name__}: sim.use_fused=True, but the kernel does not "
                                          "cover " + "; ".join(refused))
            if self.use_fused is False:
                self._route, why = "eager", ["sim.use_fused=False", *refused]
            else:
                self._route, why = ("eager", refused) if refused else ("kernel", [])
            line = f"{type(self).__name__}: physics route {self._route}" + (f" ({'; '.join(why)})" if why else "")
            if line not in _ROUTES_SHOWN and distributed.is_main_process():
                _ROUTES_SHOWN.add(line)
                print(line)
        return self._route

    # ---- hooks ---------------------------------------------------------
    def build_model(self) -> Tuple[Model, SimParams]:
        raise NotImplementedError

    def sample_init(self, generator: torch.Generator, n: int):
        raise NotImplementedError

    def compute_force(self, actions, q, qd, task):
        raise NotImplementedError

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        raise NotImplementedError

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        raise NotImplementedError

    def observe_state(self, q, qd, kin, sensors, task, actions, progress):
        """Privileged state of an asymmetric critic (num_states > 0)."""
        raise NotImplementedError

    def perturb_state(self, generator, q, qd, frames, task):
        """Changes to the state after physics (e.g. robot pushes); `frames`
        is the env-step count before this step."""
        return q, qd

    def resample_init(self, generator, old_task):
        """Init states for the envs that reset, which may read the task
        state they leave (a curriculum level)."""
        return self.sample_init(generator, self.num_envs)

    def adr_objective(self, task):
        """(N,) per-env episode objective that ADR's boundary workers push
        when their episode ends (the reference's consecutive successes)."""
        return torch.zeros(self.num_envs, device=self.device)

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress) -> dict:
        """Per-env values for `extras`, from the state after the reward."""
        return {}

    def population_update(self, task, done, progress):
        """Full-batch change of the task state after the reward and the
        extras, from statistics across envs (IndustReal's Sampling-Based
        Curriculum steps its shared max displacement from the success rate);
        returns the task state in the same structure. The step calls it
        only where a subclass overrides it."""
        return task

    # ---- dict observations ---------------------------------------------
    # The policy input stays one flat vector; a task that declares
    # `obs_spec()` ({key: (offset, size)}) also offers it as a dict of
    # named slices, as the reference's dict-observation envs do.

    def _obs_spec(self):
        return self.obs_spec() if hasattr(self, "obs_spec") else None

    @property
    def observation_dict_space(self):
        """{key: size} of the named observation slices, or None for a task
        without an obs_spec."""
        spec = self._obs_spec()
        return {k: n for k, (_, n) in spec.items()} if spec else None

    def obs_dict(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A flat obs batch (..., num_obs) split into the task's named
        slices; {"obs": obs} for a task without an obs_spec."""
        spec = self._obs_spec()
        if not spec:
            return {"obs": obs}
        return {k: obs[..., off:off + n] for k, (off, n) in spec.items()}

    def step_dict(self, state, actions):
        """`step` with the observations as `obs_dict`."""
        state, obs, rew, done, extras = self.step(state, actions)
        return state, self.obs_dict(obs), rew, done, extras

    def reset_dict(self, seed: int = 0):
        """`reset` with the observations as `obs_dict`."""
        state, obs = self.reset(seed)
        return state, self.obs_dict(obs)

    # ---- domain randomization ------------------------------------------
    def dr_actor_ranges(self):
        """Optional {actor_name: (body_lo, body_hi)} scoping the
        actor_params specs of domain randomization to each actor's bodies,
        dofs and contact points. None: every spec touches the whole leaf."""
        return None

    def set_param_generator(self, generator):
        """Install an external physics-parameter generator: a callable
        (torch.Generator, n) -> (n, P) tensor whose layout is
        `get_actor_params_info()`. Needs task.randomize=True."""
        if self.randomizer is None:
            raise ValueError(
                "set_param_generator needs task.randomize=True with actor_params randomization specs")
        if generator is not None and not callable(generator):
            raise TypeError("generator must be callable (generator, n) -> (n, P)")
        self.randomizer.param_generator = generator

    def get_actor_params_info(self):
        """Flat layout the external generator must produce: a list of {name,
        leaf, size, lo, hi, operation} in sample order, or None without DR."""
        return None if self.randomizer is None else self.randomizer.param_info()

    def set_train_info(self, env_frames, *args, **kwargs):
        """The trainer's report of its global env-frame count, once per
        epoch, kept for host-side consumers. The step's own counter
        (`EnvState.frames`) is what DR schedules read."""
        self.total_train_env_frames = int(env_frames)

    def pack_dyn(self, sample):
        """The per-env leaves and gravity of a DR sample as the route's
        physics step takes them: packed for the kernel (None when the sample
        randomizes no model leaf), a dict {leaf: (N, ...), "gravity": (N,
        3)} in the model's layout for the eager engine. Called where the
        sample changes, not per physics step."""
        rz = self.randomizer
        leaves = dict(rz.batched_model(sample))
        grav = rz.gravity(self.sim_params.gravity, sample)
        if grav is not None:
            leaves["gravity"] = grav
        if self.physics_route == "eager":
            return leaves
        leaves = {k: v for k, v in leaves.items() if k in _fused.DYN_LEAVES or k == "gravity"}
        return _fused.pack_dyn(_fused.spec_of(self.model), leaves)

    # ---- helpers shared by tasks --------------------------------------
    def sim_params_from_cfg(self) -> SimParams:
        """SimParams from the reference-schema `sim:` cfg block."""
        sim = self.cfg.get("sim", {})
        physx = sim.get("physx", {})
        return SimParams(
            dt=float(sim.get("dt", 1.0 / 60.0)),
            substeps=int(sim.get("substeps", 2)),
            solver_pgs_iterations=int(physx.get("num_position_iterations", 4)) * 2,
            solver_apgd_iterations=int(physx.get("num_position_iterations", 4)) * 4,
            gravity=tuple(float(g) for g in sim.get("gravity", [0.0, 0.0, -9.81])),
            max_depenetration_velocity=float(physx.get("max_depenetration_velocity", 10.0)),
            bounce_threshold_velocity=float(physx.get("bounce_threshold_velocity", 0.2)),
            contact_margin=float(physx.get("contact_offset", 0.02)),
            max_active_contacts=int(physx.get("max_active_contacts", 0)),
        )

    def qfrc_from_actuators(self, actions: torch.Tensor) -> torch.Tensor:
        """qfrc[:, dof(a)] += gear[a] * actions[:, a] (DOF_MODE_EFFORT)."""
        qfrc = actions.new_zeros(actions.shape[0], self.model.nv)
        return qfrc.index_add_(1, self._act_dof, self._gear * actions)

    @property
    def scalar_dof_indices(self) -> np.ndarray:
        """Indices into qd of the scalar (hinge/slide) dofs."""
        sq = _dyn.scalar_dof_q_adr(self.model)
        return np.where(sq >= 0)[0]

    def _no_sensors(self, n: int) -> Sensors:
        z = lambda *s: torch.zeros(s, device=self.device)
        return Sensors(z(n, self.model.nbody, 3), z(n, self.model.nbody, 3), z(n, self.model.nv))

    def _terrain_planes(self, q, qd):
        """The ground planes under the candidate points at (q, qd), packed
        for the physics step; None on flat ground."""
        if self.terrain is None:
            return None
        return _fused.pack_terrain(_fused.terrain_dyn(self.model, self.terrain, q, qd))

    def _sdf_planes(self, q, qd):
        """The contact planes of the SDF pair rows at (q, qd), packed for the
        physics step; None for a model without SDF pair rows."""
        if not len(self.model.spair_point):
            return None
        return _fused.pack_sdf(_fused.sdf_dyn(self.model, q, qd))

    def _kin(self, q, qd):
        return _dyn.forward_kinematics(self.model, q, qd) if self.uses_kin else None

    def states_of(self, state: EnvState) -> torch.Tensor:
        """Privileged states of the current env state (the critic's first
        input; outside the step the sensors are zero)."""
        q, qd = state.sim.q, state.sim.qd
        kin = _dyn.forward_kinematics(self.model, q, qd)
        states = self.observe_state(q, qd, kin, self._no_sensors(self.num_envs), state.task, state.actions,
                                    state.progress)
        return torch.clamp(states, -self.clip_obs, self.clip_obs)

    # ---- the batched entry points -------------------------------------
    def reset(self, seed: int = 0) -> Tuple[EnvState, torch.Tensor]:
        """Full reset of all envs; partial resets later draw from the
        state's generator, seeded here (with `seed` folded with the rank)."""
        self.physics_route  # decided (and printed) here at the latest
        gen = torch.Generator(device=self.device).manual_seed(distributed.rank_seed(seed))
        shared = gen if distributed.process_count() == 1 else torch.Generator(device=self.device).manual_seed(seed)
        n = self.num_envs
        q, qd, task = self.sample_init(gen, n)
        adr = None
        if self.adr is not None:
            adr = self.adr.init_state(shared)
            task = {**task, "adr": self.adr.sample(adr, gen, n)}
        actions = torch.zeros(n, self.num_acts, device=self.device)
        progress = torch.zeros(n, dtype=torch.int32, device=self.device)
        obs = self.observe(q, qd, self._kin(q, qd), self._no_sensors(n), task, actions, progress)
        dr = dyn = rbuf = frames = None
        if self.randomizer is not None:
            dr = self.randomizer.sample(gen, n, 0, adr=self._dr_overrides(adr))
            dyn = self.pack_dyn(dr)
            rbuf = torch.zeros(n, dtype=torch.int32, device=self.device)
        if self._counts_frames:
            frames = torch.zeros((), dtype=torch.int32, device=self.device)
        state = EnvState(
            sim=SimState(q=q, qd=qd),
            progress=progress,
            reset_buf=torch.zeros(n, dtype=torch.bool, device=self.device),
            rng=gen,
            actions=actions,
            task=task,
            dr=dr,
            dyn=dyn,
            randomize_buf=rbuf,
            frames=frames,
            adr=adr,
            shared_rng=shared,
        )
        return state, torch.clamp(obs, -self.clip_obs, self.clip_obs)

    def _dr_overrides(self, adr_state):
        return None if self.adr is None else self.adr.dr_overrides(adr_state)

    def _with_frames(self, task, frames):
        """The hooks' view of the task state: with the env-step count as
        task["_frames"] where the task asks for it."""
        return {**task, "_frames": frames} if self.frames_in_task else task

    def step(
        self, state: EnvState, actions: torch.Tensor
    ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """One vectorized env step; see the module docstring for the order."""
        n = self.num_envs
        rz, frames = self.randomizer, state.frames
        if rz is not None:
            actions = rz.action_noise(state.rng, actions, frames, dr_sample=state.dr)
        actions = torch.clamp(actions, -self.clip_actions, self.clip_actions)

        # 1. apply actions + physics
        q, qd = state.sim.q, state.sim.qd
        task_in = self._with_frames(state.task, frames)
        if self.use_pd_targets:
            qfrc, xfrc, q_target = self.compute_force(actions, q, qd, task_in)
        else:
            (qfrc, xfrc), q_target = self.compute_force(actions, q, qd, task_in), None
        if self.physics_route == "eager":
            for _ in range(self.control_freq_inv):
                out = _step.physics_step(self.model, SimState(q=q, qd=qd), qfrc, self.sim_params, xfrc=xfrc,
                                         q_target=q_target, terrain=self.terrain, leaves=state.dyn)
                q, qd = out.state.q, out.state.qd
        elif self.merge_slices:
            out = _fused.physics_step_fused(
                self.model, self._merged_params, q, qd, qfrc, xfrc=xfrc, q_target=q_target, dyn=state.dyn,
                warm_reset_every=self._warm_reset_every, terrain=self._terrain_planes(q, qd),
                sdf=self._sdf_planes(q, qd),
            )
            q, qd = out.q, out.qd
        else:
            for _ in range(self.control_freq_inv):
                out = _fused.physics_step_fused(
                    self.model, self.sim_params, q, qd, qfrc, xfrc=xfrc, q_target=q_target, dyn=state.dyn,
                    terrain=self._terrain_planes(q, qd), sdf=self._sdf_planes(q, qd),
                )
                q, qd = out.q, out.qd
        sensors = Sensors(out.body_force, out.body_torque, out.dof_force)
        if type(self).perturb_state is not VecTask.perturb_state:
            q, qd = self.perturb_state(state.rng, q, qd, frames, task_in)

        # 2. bookkeeping
        progress = state.progress + 1

        # 3. partial resets of envs flagged done last step
        done_prev, task = state.reset_buf, state.task
        if not self.costly_reset or bool(done_prev.any()):
            init_q, init_qd, init_task = self.resample_init(state.rng, task)
            if self.adr is not None:
                # the resetting envs' ADR parameters, drawn from the current ranges
                init_task = {**init_task, "adr": self.adr.sample(state.adr, state.rng, n)}
            q = _select(done_prev, init_q, q)
            qd = _select(done_prev, init_qd, qd)
            task = _select(done_prev, init_task, task)
            sensors = Sensors(*(_select(done_prev, torch.zeros_like(x), x) for x in sensors))
        progress = torch.where(done_prev, torch.zeros_like(progress), progress)

        # 3b. re-randomize the envs that reset and are due, without asking
        # the device which: a fresh sample for all, selected with a where
        dr, dyn, rbuf = state.dr, state.dyn, state.randomize_buf
        if rz is not None:
            rbuf = rbuf + 1
            due = done_prev & (rbuf >= rz.frequency)
            fresh = rz.sample(state.rng, n, frames, adr=self._dr_overrides(state.adr))
            dr = {k: v if k in self._setup_only else _select(due, fresh[k], v) for k, v in dr.items()}
            dyn = self.pack_dyn(dr)
            rbuf = torch.where(due, torch.zeros_like(rbuf), rbuf)
        if frames is not None:
            frames = frames + 1

        # 4. observe on the post-reset state
        kin = self._kin(q, qd)
        task = self._with_frames(task, frames)
        obs = self.observe(q, qd, kin, sensors, task, actions, progress)
        if rz is not None:
            obs = rz.observation_noise(state.rng, obs, frames, dr_sample=dr)
        obs = torch.clamp(obs, -self.clip_obs, self.clip_obs)

        # 5. reward + new done flags
        reward, done, task = self.reward_done(obs, q, qd, kin, sensors, task, actions, progress)
        if self.frames_in_task:
            task.pop("_frames", None)  # a view for the hooks, not state
        extras = dict(self.extra_outputs(q, qd, kin, sensors, task, actions, progress))
        if type(self).population_update is not VecTask.population_update:
            task = self.population_update(task, done, progress)

        # 6. timeout flag
        timeout = (progress >= self.max_episode_length - 1) & done

        # 6b. ADR: the finished boundary workers push their objective, full queues move their edges
        adr = state.adr
        if self.adr is not None:
            adr = self.adr.update(adr, state.shared_rng, done, self.adr_objective(task))
            extras["adr_nats"] = adr.nats.expand(n)
        new_state = EnvState(
            sim=SimState(q=q, qd=qd),
            progress=progress,
            reset_buf=done,
            rng=state.rng,
            actions=actions,
            task=task,
            dr=dr,
            dyn=dyn,
            randomize_buf=rbuf,
            frames=frames,
            adr=adr,
            shared_rng=state.shared_rng,
        )
        extras["time_outs"] = timeout
        if self.num_states:
            states = self.observe_state(q, qd, kin, sensors, task, actions, progress)
            extras["states"] = torch.clamp(states, -self.clip_obs, self.clip_obs)
        return new_state, obs, reward, done, extras
