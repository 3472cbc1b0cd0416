"""`train.main` on the hand tasks on the CPU: Trifinger (its yaml's
randomization on, the asymmetric critic), ShadowHand, AllegroHand and
AllegroHandLSTM (recurrent PPO) train at 4 envs, write a checkpoint that a
fresh agent restores bit for bit, resume and play (the hand tasks' train
tests, in a file of their own so that test workers share the train
tests)."""
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.learn import PPO, PPORecurrent
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint
from isaacgymenvs_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

# task -> (the run's name, the recipe's network cut to size)
RUNS = {"Trifinger": ("Trifinger", ["train.params.network.mlp.units=[32,16]",
                                    "train.params.config.central_value_config.network.mlp.units=[32]",
                                    "train.params.config.central_value_config.minibatch_size=16"]),
        "ShadowHand": ("ShadowHand", ["train.params.network.mlp.units=[32,16]"]),
        "AllegroHand": ("AllegroHand", ["train.params.network.mlp.units=[32,16]"]),
        "AllegroHandLSTM": ("AllegroHandLSTM", ["train.params.network.mlp.units=[16]",
                                                "train.params.network.rnn.units=16",
                                                "train.params.config.central_value_config.minibatch_size=16"])}


@pytest.mark.parametrize("task", list(RUNS))
def test_train_main_hand(task, tmp_path, capsys):
    """At 4 envs, horizon 8, minibatches of 16, episodes of 6 steps: one
    epoch and its checkpoint; a fresh agent (PPORecurrent for the LSTM
    recipe) restores it bit for bit (parameters, the central value's where
    the recipe has one, Adam moments, running stats, lr); a resume for a
    second epoch; play."""
    name, net = RUNS[task]
    run = [f"task={task}", "pipeline=cpu", "num_envs=4", f"+train_dir={tmp_path}",
           "train.params.config.horizon_length=8", "train.params.config.minibatch_size=16",
           "task.env.episodeLength=6", *net]
    ts, metrics = ttrain.main([*run, "max_iterations=1", "train.params.config.save_frequency=1"])
    assert metrics["epoch"] == 1 and metrics["frames"] == 8 * 4
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    last = str(tmp_path / name / "nn" / f"last_{name}.pth")
    ck = load_checkpoint(last)
    assert ck["epoch"] == 1
    cfg = load_config(run)
    kind = PPORecurrent if cfg["train"]["params"]["network"].get("rnn") else PPO
    assert kind is (PPORecurrent if task == "AllegroHandLSTM" else PPO)
    fresh = kind(task_map[cfg["task"]["name"]](cfg["task"], device="cpu"), cfg["train"]["params"], seed=1)
    fts, epoch = fresh.restore(last, fresh.init())
    assert epoch == 1 and fts.lr == ts.lr
    # the policy's parameters and, with the asymmetric critic, the central value's
    trained, restored = ts.optimizer.param_groups[0]["params"], fts.optimizer.param_groups[0]["params"]
    assert all(torch.equal(a, b) for a, b in zip(restored, trained, strict=True))
    for a, b in ((fts.obs_rms, ts.obs_rms), (fts.value_rms, ts.value_rms)):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    fst, tst = fts.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"]
    assert set(fst) == set(tst) and all(torch.equal(fst[i][k], tst[i][k]) for i in tst
                                        for k in ("step", "exp_avg", "exp_avg_sq"))
    _, resumed = ttrain.main([*run, "max_iterations=2", f"checkpoint={last}"])
    assert resumed["epoch"] == 2
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert np.isfinite(mean_ret) and "played" in capsys.readouterr().out
