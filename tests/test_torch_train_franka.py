"""`train.main task=FrankaCubeStack|FrankaCabinet pipeline=cpu` at 4 envs:
train, checkpoint, resume and play (the Franka slice's train tests, in a
file of their own so that test workers share the train tests)."""
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

# task -> (its task state's key, the yaml's network cut down for the CPU)
TASKS = {"FrankaCubeStack": "stack", "FrankaCabinet": "targets"}


@pytest.mark.parametrize("task", list(TASKS))
def test_train_main_franka(task, tmp_path, capsys):
    """Two epochs of horizon 4 with a checkpoint each (minibatch 8 of the
    batch of 16, the recipe's MLP cut to [32, 16]), a resume for a third, and
    play; episodes cut to 4 steps so that play finishes its 32 episodes in
    32 steps. FrankaCubeStack runs its OSC every step. The checkpoint
    carries the task state (`stack`, `targets`)."""
    run = [f"task={task}", "pipeline=cpu", "num_envs=4", f"+train_dir={tmp_path}",
           "train.params.config.horizon_length=4", "train.params.config.minibatch_size=8",
           "train.params.network.mlp.units=[32,16]", "task.env.episodeLength=4"]
    ts, metrics = ttrain.main([*run, "max_iterations=2", "train.params.config.save_frequency=1"])
    assert metrics["epoch"] == 2 and metrics["frames"] == 2 * 4 * 4
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    names = sorted(p.name for p in (tmp_path / task / "nn").iterdir())
    assert names == [f"last_{task}.pth", f"last_{task}_ep_1.pth", f"last_{task}_ep_2.pth"]
    last = str(tmp_path / task / "nn" / f"last_{task}.pth")
    ck = load_checkpoint(last)
    key = TASKS[task]
    assert ck["epoch"] == 2 and torch.equal(ck["env_task_state"][key], ts.env_state.task[key])
    _, resumed = ttrain.main([*run, "max_iterations=3", f"checkpoint={last}"])
    assert resumed["epoch"] == 3
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert np.isfinite(mean_ret) and "played" in capsys.readouterr().out
