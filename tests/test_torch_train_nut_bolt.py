"""`train.main task=FactoryTaskNutBolt{Pick,Place,Screw} pipeline=cpu` at 8
envs: train, checkpoint, a bit-equal restore, resume and play (the nut-bolt
slice's train tests, in a file of their own so that test workers share the
train tests)."""
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.learn import PPO
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint
from isaacgymenvs_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

# the episodes cut short for play: Pick's acting phase to 2 steps and its
# scripted close and lift to 1 each (4 steps), the others' to 4
SHORT = {"FactoryTaskNutBoltPick": ("task.env.episodeLength=2", "task.env.num_gripper_close_sim_steps=1",
                                    "task.env.num_gripper_lift_sim_steps=1"),
         "FactoryTaskNutBoltPlace": ("task.env.episodeLength=4",),
         "FactoryTaskNutBoltScrew": ("task.env.episodeLength=4",)}


@pytest.mark.parametrize("task", list(SHORT))
def test_train_main_nut_bolt(task, tmp_path, capsys):
    """One epoch of horizon 4 with a checkpoint (minibatch 16 of the batch
    of 32, the recipe's MLP cut to [32, 16]); a fresh agent restores it bit
    for bit (parameters, Adam moments, running stats, lr, Pick's task state
    `t`); a resume for a second epoch; play, whose 32 episodes the cut
    episodes finish in 16 steps."""
    run = [f"task={task}", "pipeline=cpu", "num_envs=8", f"+train_dir={tmp_path}",
           "train.params.config.horizon_length=4", "train.params.config.minibatch_size=16",
           "train.params.network.mlp.units=[32,16]", *SHORT[task]]
    ts, metrics = ttrain.main([*run, "max_iterations=1", "train.params.config.save_frequency=1"])
    assert metrics["epoch"] == 1 and metrics["frames"] == 4 * 8
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    last = str(tmp_path / task / "nn" / f"last_{task}.pth")
    ck = load_checkpoint(last)
    assert ck["epoch"] == 1
    if task == "FactoryTaskNutBoltPick":
        assert torch.equal(ck["env_task_state"]["t"], ts.env_state.task["t"])
    else:
        assert ck["env_task_state"] == ()
    cfg = load_config(run)
    fresh = PPO(task_map[task](cfg["task"], device="cpu"), cfg["train"]["params"], seed=1)
    fts, epoch = fresh.restore(last, fresh.init())
    assert epoch == 1 and fts.lr == ts.lr
    trained = ts.optimizer.param_groups[0]["params"]
    assert all(torch.equal(a, b) for a, b in zip(fresh.network.parameters(), trained, strict=True))
    for a, b in ((fts.obs_rms, ts.obs_rms), (fts.value_rms, ts.value_rms)):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    fst, tst = fts.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"]
    assert set(fst) == set(tst) and all(torch.equal(fst[i][k], tst[i][k]) for i in tst
                                        for k in ("step", "exp_avg", "exp_avg_sq"))
    _, resumed = ttrain.main([*run, "max_iterations=2", f"checkpoint={last}"])
    assert resumed["epoch"] == 2
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert np.isfinite(mean_ret) and "played" in capsys.readouterr().out
