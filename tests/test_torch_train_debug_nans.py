"""`debug_nans=True` in the port's `train.main`, on the CPU: the torch
counterpart of the JAX package's `jax_debug_nans` (root train.py:45-46)."""
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.tasks import task_map

torch.set_num_threads(1)

RUN = ["task=Cartpole", "pipeline=cpu", "num_envs=8", "max_iterations=1", "train.params.config.horizon_length=4",
       "train.params.config.minibatch_size=16"]


def _nan_rewards(monkeypatch, after: int):
    """Cartpole's reward turns NaN from env step `after` on."""
    cls = task_map["Cartpole"]
    orig = cls.reward_done

    def reward_done(self, *a):
        reward, done, task = orig(self, *a)
        progress = a[-1]
        return torch.where(progress >= after, torch.full_like(reward, float("nan")), reward), done, task

    monkeypatch.setattr(cls, "reward_done", reward_done)


def test_debug_nans_raises_on_a_nan_reward_and_is_off_by_default(tmp_path, monkeypatch):
    """With a reward made NaN from the third env step: the run without the
    flag trains its epoch (the NaN flows into the loss unchecked), the run
    with `debug_nans=True` stops at that step with FloatingPointError
    naming the reward."""
    _nan_rewards(monkeypatch, after=3)
    _, metrics = ttrain.main([*RUN, f"+train_dir={tmp_path / 'off'}"])
    assert metrics["epoch"] == 1 and not np.isfinite(metrics["c_loss"])
    with pytest.raises(FloatingPointError, match="env step reward"):
        ttrain.main([*RUN, f"+train_dir={tmp_path / 'on'}", "debug_nans=True"])


def test_debug_nans_checks_the_loss_and_passes_a_clean_run(tmp_path, monkeypatch):
    """A clean run trains as usual under the flag (the checks and anomaly
    detection change no value); a loss made NaN raises FloatingPointError
    naming the loss."""
    _, clean = ttrain.main([*RUN, f"+train_dir={tmp_path / 'a'}", "seed=3"])
    _, checked = ttrain.main([*RUN, f"+train_dir={tmp_path / 'b'}", "seed=3", "debug_nans=True"])
    for k in ("a_loss", "c_loss", "kl"):
        assert checked[k] == clean[k] and np.isfinite(checked[k])
    from isaacgymenvs_tpu_torch.learn import PPO

    orig = PPO._loss
    monkeypatch.setattr(PPO, "_loss", lambda self, *a, **k: (lambda t, aux: (t * float("nan"), aux))(
        *orig(self, *a, **k)))
    with pytest.raises(FloatingPointError, match="loss"):
        ttrain.main([*RUN, f"+train_dir={tmp_path / 'c'}", "debug_nans=True"])
