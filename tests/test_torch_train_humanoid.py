"""`train.main` with the SAC and the recurrent PPO recipes, on the CPU:
`task=Humanoid train=HumanoidSAC`, `task=Ant train=AntSAC` and
`task=AnymalTerrain train=AnymalTerrainPPO_LSTM` at a few envs: train, a
resume from the checkpoint, play, and a `profile=` trace (split out of
tests/test_torch_train.py so that test workers share the train tests)."""
import os

import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)


@pytest.mark.parametrize("task, recipe", [("Humanoid", "HumanoidSAC"), ("Ant", "AntSAC")])
def test_train_main_sac(tmp_path, capsys, task, recipe):
    """algo.name=sac trains with SAC: three epochs of 8 env steps (updates
    from the fifth step on), a checkpoint of the learnable leaves only, a
    resume from it with a profile trace of its epoch, and play."""
    run = [f"task={task}", f"train={recipe}", "pipeline=cpu", "num_envs=8", f"+train_dir={tmp_path}",
           "train.params.config.batch_size=32", "train.params.config.replay_buffer_size=1024",
           "train.params.config.num_warmup_steps=4", "train.params.config.num_seed_steps=2",
           "train.params.network.mlp.units=[32,32]", "task.env.episodeLength=16"]
    ts, metrics = ttrain.main([*run, "max_iterations=3"])
    assert metrics["epoch"] == 3 and metrics["frames"] == 3 * 8 * 8
    assert all(np.isfinite(metrics[k]) for k in ("c_loss", "a_loss", "alpha")) and metrics["c_loss"] > 0
    assert ts.buffer.size == 3 * 8 * 8 and ts.total_steps == 24
    ckpt = tmp_path / recipe / "nn" / f"{recipe}.pth"
    assert set(load_checkpoint(str(ckpt))) == {"actor_params", "critic_params", "target_params", "log_alpha",
                                               "obs_rms"}
    trace = tmp_path / "trace"
    _, resumed = ttrain.main([*run, "max_iterations=1", f"checkpoint={ckpt}", f"+profile={trace}"])
    assert resumed["epoch"] == 1 and np.isfinite(resumed["c_loss"]) and resumed["alpha"] > 0
    assert any(f.endswith(".json") for f in os.listdir(trace))
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={ckpt}"])
    out = capsys.readouterr().out
    assert np.isfinite(mean_ret) and "played" in out and "[profile] trace written" in out


def test_train_main_anymal_terrain_lstm(tmp_path, capsys):
    """A network.rnn block trains with PPORecurrent: AnymalTerrain at 4 envs
    on a small grid (horizon 24 in windows of 4), an epoch with a
    checkpoint, a resume for a second, and play with the carry threaded."""
    run = ["task=AnymalTerrain", "train=AnymalTerrainPPO_LSTM", "pipeline=cpu", "num_envs=4",
           f"+train_dir={tmp_path}", "task.env.terrain.numLevels=3", "task.env.terrain.numTerrains=4",
           "train.params.config.minibatch_size=48", "train.params.network.rnn.units=32",
           "train.params.network.mlp.units=[32,16]", "task.env.learn.episodeLength_s=0.2"]
    ts, metrics = ttrain.main([*run, "max_iterations=1"])
    assert metrics["epoch"] == 1 and metrics["frames"] == 24 * 4
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    assert ts.carry[0].shape == (4, 32) and float(ts.carry[1].abs().max()) > 0
    last = tmp_path / "AnymalTerrainLSTM" / "nn" / "last_AnymalTerrainLSTM.pth"
    assert any(k.startswith("lstm.") for k in load_checkpoint(str(last))["params"])
    _, resumed = ttrain.main([*run, "max_iterations=2", f"checkpoint={last}"])
    assert resumed["epoch"] == 2
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert np.isfinite(mean_ret) and "played" in capsys.readouterr().out
