"""PPO rollout (port of the rollout half of isaacgymenvs_tpu/learn/ppo.py).

`PPO.rollout` collects `horizon_length` transitions over all envs under
the current policy: running-mean-std obs normalization, Gaussian action
sampling from an explicit `torch.Generator`, shaped reward with timeout
value bootstrap, episode bookkeeping, and the bootstrap value of the
state after the last transition. GAE, the loss, the update, checkpoints
and `play` are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple

import torch

from ..envcore.vec_task import EnvState, VecTask
from .networks import ActorCritic
from .running_stats import RunningMeanStd, rms_denormalize, rms_normalize, rms_update


class PPOConfig(NamedTuple):
    """The rollout's hyperparameters; names follow the train-yaml keys.
    Input and value normalization are always on, as in AntPPO.yaml."""

    gamma: float = 0.99
    horizon_length: int = 16
    value_bootstrap: bool = False
    reward_scale: float = 1.0  # reward_shaper.scale_value

    @classmethod
    def from_train_cfg(cls, params: Dict[str, Any]) -> "PPOConfig":
        c = params.get("config", params)
        return cls(
            gamma=float(c.get("gamma", 0.99)),
            horizon_length=int(c.get("horizon_length", 16)),
            value_bootstrap=bool(c.get("value_bootstrap", False)),
            reward_scale=float(c.get("reward_shaper", {}).get("scale_value", 1.0)),
        )


@dataclasses.dataclass
class PPOTrainState:
    env_state: EnvState
    obs: torch.Tensor  # (N, num_obs) last observation
    obs_rms: RunningMeanStd
    value_rms: RunningMeanStd
    ep_return: torch.Tensor  # (N,) running episode return (raw rewards)
    ep_len: torch.Tensor  # (N,) int32
    generator: torch.Generator  # action noise


class Transition(NamedTuple):
    """Rollout buffers, time-leading (T, N, ...)."""

    obs: torch.Tensor
    action: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor  # log-sigma, as in the JAX package
    logp: torch.Tensor
    value: torch.Tensor  # raw (denormalized)
    reward: torch.Tensor  # shaped + bootstrapped
    done: torch.Tensor
    ep_ret_done: torch.Tensor  # (T,) sum of returns of episodes finished
    ep_len_done: torch.Tensor
    n_done: torch.Tensor


_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _gaussian_logp(x, mu, log_sigma):
    return torch.sum(
        -0.5 * ((x - mu) / torch.exp(log_sigma)) ** 2 - log_sigma - _LOG_SQRT_2PI, dim=-1
    )


class PPO:
    """PPO bound to a VecTask env (the rollout half)."""

    def __init__(self, env: VecTask, train_params: Dict[str, Any], seed: int = 0):
        self.env = env
        self.cfg = PPOConfig.from_train_cfg(train_params)
        net_cfg = train_params.get("network", {})
        mlp = net_cfg.get("mlp", {})
        space = net_cfg.get("space", {}).get("continuous", {})
        c = train_params.get("config", train_params)
        unsupported = {
            "mlp.activation": mlp.get("activation", "elu") != "elu",
            "mlp.d2rl": bool(mlp.get("d2rl", False)),
            "network.separate": bool(net_cfg.get("separate", False)),
            "space.learn_sigma": not space.get("learn_sigma", True),
            "config.normalize_input": not c.get("normalize_input", True),
            "config.normalize_value": not c.get("normalize_value", True),
        }
        if any(unsupported.values()):
            raise NotImplementedError(
                f"train config options not ported: {[k for k, v in unsupported.items() if v]}"
            )
        self.seed = seed
        torch.manual_seed(seed)
        self.network = ActorCritic(
            env.num_obs,
            env.num_acts,
            units=tuple(mlp.get("units", (256, 128, 64))),
            sigma_init=float(space.get("sigma_init", {}).get("val", 0.0)),
        ).to(env.device)

    def init(self) -> PPOTrainState:
        env, dev = self.env, self.env.device
        env_state, obs = env.reset(self.seed)
        return PPOTrainState(
            env_state=env_state,
            obs=obs,
            obs_rms=RunningMeanStd.create((env.num_obs,), dev),
            value_rms=RunningMeanStd.create((), dev),
            ep_return=torch.zeros(env.num_envs, device=dev),
            ep_len=torch.zeros(env.num_envs, dtype=torch.int32, device=dev),
            generator=torch.Generator(device=dev).manual_seed(self.seed + 1),
        )

    @torch.no_grad()
    def rollout(self, ts: PPOTrainState, noise: torch.Tensor | None = None):
        """Collect one horizon. `noise` (T, N, num_acts) replaces the
        standard-normal action noise drawn from `ts.generator`.

        Returns (ts, traj: Transition, last_value).
        """
        cfg = self.cfg
        env_state, obs, obs_rms = ts.env_state, ts.obs, ts.obs_rms
        ep_ret, ep_len = ts.ep_return, ts.ep_len
        steps = []
        for t in range(cfg.horizon_length):
            obs_rms = rms_update(obs_rms, obs)
            mu, log_sigma, v_norm = self.network(rms_normalize(obs_rms, obs))
            value = rms_denormalize(ts.value_rms, v_norm)
            eps = (
                noise[t]
                if noise is not None
                else torch.randn(mu.shape, generator=ts.generator, device=mu.device)
            )
            action = mu + torch.exp(log_sigma) * eps
            logp = _gaussian_logp(action, mu, log_sigma)

            env_state, next_obs, reward, done, extras = self.env.step(env_state, action)
            shaped = reward * cfg.reward_scale
            if cfg.value_bootstrap:
                shaped = shaped + cfg.gamma * value * extras["time_outs"].to(value.dtype)
            ep_ret = ep_ret + reward
            ep_len = ep_len + 1
            steps.append(Transition(
                obs=obs, action=action, mu=mu, sigma=log_sigma, logp=logp, value=value,
                reward=shaped, done=done,
                ep_ret_done=torch.sum(torch.where(done, ep_ret, torch.zeros_like(ep_ret))),
                ep_len_done=torch.sum(torch.where(done, ep_len, torch.zeros_like(ep_len))),
                n_done=torch.sum(done),
            ))
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
            obs = next_obs
        traj = Transition(*(torch.stack(x) for x in zip(*steps)))
        ts = dataclasses.replace(
            ts, env_state=env_state, obs=obs, obs_rms=obs_rms, ep_return=ep_ret, ep_len=ep_len
        )
        # bootstrap value for the state after the last transition
        _, _, v_norm = self.network(rms_normalize(obs_rms, obs))
        return ts, traj, rms_denormalize(ts.value_rms, v_norm)
