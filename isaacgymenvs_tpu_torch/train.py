"""Train / play entry point of the port.

    python -m isaacgymenvs_tpu_torch.train task=Ant
    python -m isaacgymenvs_tpu_torch.train task=Cartpole max_iterations=100
    python -m isaacgymenvs_tpu_torch.train task=Cartpole test=True checkpoint=runs/Cartpole/nn/Cartpole.pth
    python -m isaacgymenvs_tpu_torch.train task=Humanoid train=HumanoidSAC
    python -m isaacgymenvs_tpu_torch.train task=AnymalTerrain train=AnymalTerrainPPO_LSTM
    python -m isaacgymenvs_tpu_torch.train task=HumanoidAMP
    python -m isaacgymenvs_tpu_torch.train task=HumanoidAMP train.params.algo.name=hrl_continuous

The flags are those of the JAX package's root train.py (the IsaacGymEnvs
Hydra launcher's): any config leaf can be overridden with a dotted path,
e.g. `train.params.config.minibatch_size=16384`, `num_envs=512`, `seed=7`,
`experiment=MyAnt`, `sigma=0.5`. `+train_dir=<dir>` puts the run directory
(`<dir>/<name>/{config.yaml,nn/,summaries/}`) elsewhere than `runs/`.
`train.params.algo.name=sac` (the SAC yamls) trains with `learn.SAC`,
`amp_continuous` (HumanoidAMPPPO.yaml) with `learn.AMPAgent`,
`hrl_continuous` with `learn.HRL` (latent macro actions over a frozen
low-level controller, `llc_*` keys of `params.config`), a `network.rnn`
block with `learn.PPORecurrent`, anything else with `PPO`.
`+profile=<dir>` writes a torch.profiler trace (CPU and CUDA activity) of
the first `profile_epochs` (default 3) epochs to <dir>, one file per run,
readable in TensorBoard or chrome://tracing.
`debug_nans=True` is the counterpart of the JAX package's `jax_debug_nans`:
every env step checks its q, qd, observations and rewards, every update
its losses, for finite values, and raises FloatingPointError naming the
first tensor that is not; the update runs under torch's anomaly
detection. Each check waits for the device, so keep it off for speed.

`pbt=pbt_default` trains the run as one member of a population
(`utils.pbt_loop.run_pbt_training`: PPO for every algo but SAC, which
trains without PBT): `pbt.policy_idx=<i>` of `pbt.num_policies`,
`pbt.mutation_file=ant_mutation` for the Ant scheme; `pbt.launcher`
starts a whole population.

`multi_gpu=True` trains one rank per process, under torchrun:

    python -m torch.distributed.run --nproc_per_node=2 -m isaacgymenvs_tpu_torch.train task=Ant multi_gpu=True

Each rank steps its block of `num_envs` on its card (`cuda:<LOCAL_RANK>`)
and the epoch is the one a single process computes over all the envs
(`parallel/`): params broadcast from rank 0, gradients, moments and
metrics summed over the ranks. The backend is NCCL; ranks that share a
card (or the CPU) need `dist_backend=gloo`, and NCCL with more ranks than
cards raises. Checkpoints, the logs, the config snapshot, the profile and
the prints are rank 0's; every rank restores `checkpoint=`. SAC and PBT
train in one process and raise with more than one rank.

It runs on the card. `pipeline=cpu` or a `sim_device` that starts with
`cpu` asks for the CPU; without a GPU and without such a flag it fails
with the device error, it does not train on the CPU. Video capture is not
ported yet and exits with a message that says so.
"""
from __future__ import annotations

import contextlib
import os
import random
import sys

import torch
import yaml

from .learn import HRL, PPO, SAC, AMPAgent, PPORecurrent
from .parallel import distributed
from .tasks import task_map
from .utils.config import load_config
from .utils.loggers import build_logger


def _unported(cfg):
    """Names of the requested options that the port does not carry yet."""
    asked = {
        "capture_video": bool(cfg.get("capture_video")),
    }
    return [k for k, v in asked.items() if v]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = load_config(argv)

    on_cpu = str(cfg.get("pipeline", "gpu")) == "cpu" or str(cfg.get("sim_device", "")).startswith("cpu")
    device = "cpu" if on_cpu else "cuda"
    # the process group of torchrun's variables (multi_gpu=True asks for one); left where it was joined
    joins = not distributed.is_initialized()
    distributed.maybe_initialize(require=bool(cfg.get("multi_gpu")), backend=str(cfg.get("dist_backend") or "")
                                 or None, device=device)
    try:
        return _main(cfg, distributed.rank_device(device))
    finally:
        if joins:
            distributed.shutdown()


def _main(cfg, device):
    main_rank = distributed.is_main_process()

    seed = int(cfg.get("seed", 42) or 42)
    if seed == -1:
        if distributed.process_count() > 1:
            raise SystemExit("seed=-1 draws a seed of its own on every rank: give multi_gpu runs a seed")
        seed = random.randint(0, 2**31 - 1)
        print(f"seed=-1 -> sampled seed {seed}")

    train_params = cfg.get("train", {}).get("params", {})
    unported = _unported(cfg)
    if unported:
        raise SystemExit(f"not ported yet: {', '.join(unported)}")

    task_name = cfg["task_name"]
    if task_name not in task_map:
        # variant configs alias an implemented class through their name: field
        yaml_name = (cfg.get("task") or {}).get("name")
        if yaml_name in task_map:
            task_name = yaml_name
    if task_name not in task_map:
        raise SystemExit(f"unknown task {task_name!r}; available: {sorted(task_map)}")
    env = task_map[task_name](cfg["task"], device=device)
    if main_rank:
        print(
            f"task={task_name} num_envs={env.global_num_envs} num_obs={env.num_obs} "
            f"num_acts={env.num_acts} device={env.device} ranks={distributed.process_count()} "
            f"backend={distributed.backend()}"
        )

    algo = str(train_params.get("algo", {}).get("name", "a2c_continuous"))
    if algo == "sac":
        agent = SAC(env, train_params, seed=seed)
    elif algo == "amp_continuous":
        agent = AMPAgent(env, train_params, seed=seed)
    elif algo == "hrl_continuous":
        agent = HRL(env, train_params, seed=seed)
    elif train_params.get("network", {}).get("rnn"):
        agent = PPORecurrent(env, train_params, seed=seed)
    else:
        agent = PPO(env, train_params, seed=seed)
    run_name = train_params.get("config", {}).get("name") or task_name
    checkpoint = str(cfg.get("checkpoint") or "") or None

    sigma = cfg.get("sigma")
    if sigma not in (None, "") and hasattr(agent, "override_sigma"):
        # fixed exploration sigma, applied to fresh inits and after a restore
        orig_init, orig_restore = agent.init, agent.restore

        def init_with_sigma():
            return agent.override_sigma(orig_init(), float(sigma))

        def restore_with_sigma(path, ts):
            ts2, epoch = orig_restore(path, ts)
            return agent.override_sigma(ts2, float(sigma)), epoch

        agent.init, agent.restore = init_with_sigma, restore_with_sigma

    guard = contextlib.nullcontext()
    if cfg.get("debug_nans"):
        _check_nans(agent)
        guard = torch.autograd.set_detect_anomaly(True)

    if cfg.get("test"):
        with guard:
            return agent.play(checkpoint=checkpoint)

    train_dir = str(cfg.get("train_dir") or "runs")
    if main_rank:
        run_dir = os.path.join(train_dir, run_name)
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg, f, default_flow_style=False, sort_keys=False)

    max_iters = cfg.get("max_iterations")
    logger = build_logger(cfg, run_name, train_dir)
    pbt_cfg = cfg.get("pbt") or {}
    if pbt_cfg.get("enabled") and algo != "sac":
        from .utils.pbt_loop import run_pbt_training

        try:
            with guard:
                return run_pbt_training(cfg, env, train_params, seed, run_name, logger, pbt_cfg, train_dir)
        finally:
            if logger is not None:
                logger.close()
    profile_dir = str(cfg.get("profile") or "") if main_rank else ""
    profiler = _Profiler(profile_dir, int(cfg.get("profile_epochs", 3)), agent.env.device)
    kw = {} if algo == "sac" else {
        "save_best_after": int(train_params.get("config", {}).get("save_best_after", 100))}
    try:
        with guard:
            return agent.train(
                max_epochs=int(max_iters) if max_iters else None,
                checkpoint=checkpoint,
                train_dir=train_dir,
                name=run_name,
                logger=logger,
                on_epoch=profiler.on_epoch if profiler.active else None,
                **kw,
            )
    finally:
        profiler.stop()
        if logger is not None:
            logger.close()


def _finite(name: str, t: torch.Tensor) -> None:
    if not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"debug_nans: {name} holds a non-finite value")


def _check_nans(agent) -> None:
    """debug_nans=True: wrap the agent's env step and its losses so that
    each result is checked for finite values (`_finite`)."""
    env = agent.env
    step = env.step

    def checked_step(state, actions):
        out = step(state, actions)
        new_state, obs, reward = out[0], out[1], out[2]
        for name, t in (("q", new_state.sim.q), ("qd", new_state.sim.qd), ("obs", obs), ("reward", reward)):
            _finite(f"env step {name}", t)
        return out

    env.step = checked_step
    if hasattr(agent, "_loss"):  # PPO and its subclasses
        loss = agent._loss

        def checked_loss(*a, **k):
            total, aux = loss(*a, **k)
            _finite("loss", total)
            return total, aux

        agent._loss = checked_loss
    if hasattr(agent, "_step"):  # SAC: one optimizer step per loss
        opt_step = agent._step

        def checked_opt_step(opt, loss, params):
            _finite("loss", loss)
            return opt_step(opt, loss, params)

        agent._step = checked_opt_step


class _Profiler:
    """`profile=<dir>`: a torch.profiler trace of the first `epochs` training
    epochs, written to <dir> when they are done (or the run ends)."""

    def __init__(self, out_dir: str, epochs: int, device):
        self.out_dir, self.left, self.prof = out_dir, epochs, None
        if not out_dir:
            return
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(out_dir))
        self.prof.start()
        print(f"[profile] tracing the first {epochs} epochs -> {out_dir}")

    @property
    def active(self) -> bool:
        return self.prof is not None

    def on_epoch(self, ts, metrics) -> bool:
        self.left -= 1
        if self.left <= 0:
            self.stop()
        return False

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()
            self.prof = None
            print(f"[profile] trace written to {self.out_dir}")


if __name__ == "__main__":
    main()
