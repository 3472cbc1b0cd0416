"""`train.main` on the AllegroKuka tasks on the CPU: every task name (the
two resolvers `AllegroKuka` and `AllegroKukaTwoArms`, the five classes and
the two LSTM yamls, recurrent PPO) trains at 4 envs, writes a checkpoint
that a fresh agent restores bit for bit, resumes and plays; and a
saveStates run writes an initial-state bank that an env with
loadInitialStates resets from (the AllegroKuka train tests, in a file of
their own so that test workers share the train tests)."""
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.learn import PPO, PPORecurrent
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint
from isaacgymenvs_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

SMALL = ["train.params.network.mlp.units=[32,16]"]
LSTM = ["train.params.network.mlp.units=[16]", "train.params.network.rnn.units=16"]
# task name -> (the run's name, the class train.main builds, overrides)
RUNS = {"AllegroKuka": ("AllegroKukaReorientation", "AllegroKukaReorientation", SMALL),
        "AllegroKukaReorientation": ("AllegroKukaReorientation", "AllegroKukaReorientation", SMALL),
        "AllegroKukaRegrasping": ("AllegroKukaRegrasping", "AllegroKukaRegrasping", SMALL),
        "AllegroKukaThrow": ("AllegroKukaThrow", "AllegroKukaThrow", SMALL),
        "AllegroKukaLSTM": ("AllegroKukaLSTM", "AllegroKukaReorientation", LSTM),
        "AllegroKukaTwoArms": ("AllegroKukaTwoArmsReorientation", "AllegroKukaTwoArmsReorientation", SMALL),
        "AllegroKukaTwoArmsReorientation": ("AllegroKukaTwoArmsReorientation", "AllegroKukaTwoArmsReorientation",
                                            SMALL),
        "AllegroKukaTwoArmsRegrasping": ("AllegroKukaTwoArmsRegrasping", "AllegroKukaTwoArmsRegrasping", SMALL),
        "AllegroKukaTwoArmsLSTM": ("AllegroKukaTwoArmsLSTM", "AllegroKukaTwoArmsReorientation", LSTM)}


@pytest.mark.parametrize("task", list(RUNS))
def test_train_main_allegro_kuka(task, tmp_path, capsys):
    """At 4 envs, horizon 8, minibatches of 16, episodes of 6 steps: one
    epoch and its checkpoint; a fresh agent (PPORecurrent for the LSTM
    yamls) restores it bit for bit (parameters, Adam moments, running stats,
    lr); a resume for a second epoch; play."""
    name, cls, net = RUNS[task]
    run = [f"task={task}", "pipeline=cpu", "num_envs=4", f"+train_dir={tmp_path}",
           "train.params.config.horizon_length=8", "train.params.config.minibatch_size=16",
           "task.env.episodeLength=6", *net]
    ts, metrics = ttrain.main([*run, "max_iterations=1", "train.params.config.save_frequency=1"])
    assert metrics["epoch"] == 1 and metrics["frames"] == 8 * 4
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    # the feed-forward learner sums the per-step reward terms (the recurrent one does not, as in the JAX package)
    assert ("episode_cumulative/lifting_rew" in metrics) == ("LSTM" not in task)
    last = str(tmp_path / name / "nn" / f"last_{name}.pth")
    assert load_checkpoint(last)["epoch"] == 1
    cfg = load_config(run)
    kind = PPORecurrent if cfg["train"]["params"]["network"].get("rnn") else PPO
    assert kind is (PPORecurrent if "LSTM" in task else PPO)
    env = task_map[task if task in task_map else cfg["task"]["name"]](cfg["task"], device="cpu")
    assert type(env).__name__ == cls
    fresh = kind(env, cfg["train"]["params"], seed=1)
    fts, epoch = fresh.restore(last, fresh.init())
    assert epoch == 1 and fts.lr == ts.lr
    trained = ts.optimizer.param_groups[0]["params"]  # the trained network's parameters, in optimizer order
    for (n, a), b in zip(fresh.named_trainables(), trained, strict=True):
        assert torch.equal(a, b), n
    for a, b in ((fts.obs_rms, ts.obs_rms), (fts.value_rms, ts.value_rms)):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    fst, tst = fts.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"]
    assert set(fst) == set(tst) and all(torch.equal(fst[i][k], tst[i][k]) for i in tst
                                        for k in ("step", "exp_avg", "exp_avg_sq"))
    _, resumed = ttrain.main([*run, "max_iterations=2", f"checkpoint={last}"])
    assert resumed["epoch"] == 2
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert np.isfinite(mean_ret) and "played" in capsys.readouterr().out


def test_train_main_save_states_bank(tmp_path):
    """`task.env.saveStates=True` with a saveStatesFile: 21 epochs through
    `train.main` take 21 snapshots (one per epoch), and the dump at exit
    writes 21 // 10 = 2 rows per env; an env with loadInitialStates on that
    bank resets every env to a bank row."""
    bank = str(tmp_path / "bank.npz")
    run = ["task=AllegroKukaReorientation", "pipeline=cpu", "num_envs=2", f"+train_dir={tmp_path}",
           "train.params.config.horizon_length=2", "train.params.config.minibatch_size=4",
           "train.params.config.mini_epochs=1", "max_iterations=21", *SMALL, "task.env.saveStates=True",
           f"task.env.saveStatesFile={bank}"]
    ttrain.main(run)
    data = np.load(bank)
    assert data["q"].shape == (4, 30) and data["qd"].shape == (4, 29)
    cfg = load_config(["task=AllegroKukaReorientation", "num_envs=4", "task.env.loadInitialStates=True",
                       f"task.env.loadStatesFile={bank}"])["task"]
    env = task_map["AllegroKukaReorientation"](cfg, device="cpu")
    state, obs = env.reset(5)
    for e in range(4):
        assert np.abs(data["q"] - state.sim.q.numpy()[e][None]).max(-1).min() < 1e-6
    assert bool(torch.isfinite(obs).all())
