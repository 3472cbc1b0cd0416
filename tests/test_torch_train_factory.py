"""`train.main task=FactoryTaskInsertion pipeline=cpu` at 4 envs: train,
checkpoint, resume and play (the Insertion slice's train test, in a file of
its own so that test workers share the train tests)."""
import numpy as np
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint


def test_train_main_factory_insertion(tmp_path, capsys):
    """Two epochs of horizon 8 with a checkpoint each (minibatch 16 of the
    batch of 32), a resume for a third, and play; episodes cut to 4 steps so
    that play finishes its 32 episodes in 32 steps. The template's reward is
    zero, its observation zero: the update runs on the value and entropy
    terms alone."""
    task = "FactoryTaskInsertion"
    run = [f"task={task}", "pipeline=cpu", "num_envs=4", f"+train_dir={tmp_path}",
           "train.params.config.horizon_length=8", "train.params.config.minibatch_size=16",
           "task.env.episodeLength=4"]
    ts, metrics = ttrain.main([*run, "max_iterations=2", "train.params.config.save_frequency=1"])
    assert metrics["epoch"] == 2 and metrics["frames"] == 2 * 8 * 4
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    names = sorted(p.name for p in (tmp_path / task / "nn").iterdir())
    assert names == [f"last_{task}.pth", f"last_{task}_ep_1.pth", f"last_{task}_ep_2.pth"]
    last = str(tmp_path / task / "nn" / f"last_{task}.pth")
    ck = load_checkpoint(last)
    assert ck["epoch"] == 2 and ck["frames"] == metrics["frames"]
    assert torch.equal(ck["env_task_state"]["q_ref"], ts.env_state.task["q_ref"])
    _, resumed = ttrain.main([*run, "max_iterations=3", f"checkpoint={last}"])
    assert resumed["epoch"] == 3
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert mean_ret == 0.0 and "played" in capsys.readouterr().out
