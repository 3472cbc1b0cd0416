"""`train.main task=IndustRealTask{Pegs,Gears}Insert` on the CPU: both names
load the JAX package's config and resolve to recurrent PPO (their recipes
carry a `network.rnn` block), and PegsInsert trains at 4 envs, restores its
checkpoint bit for bit, resumes and plays (the IndustReal slice's train
tests, in a file of their own so that test workers share the train tests)."""
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.learn import PPORecurrent
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint
from isaacgymenvs_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

TASKS = ["IndustRealTaskPegsInsert", "IndustRealTaskGearsInsert"]


@pytest.mark.parametrize("task", TASKS)
def test_load_config_matches_jax_and_resolves_to_ppo_recurrent(task, monkeypatch):
    """The port's `load_config` of the name equals the JAX package's dict
    (but for the device flags, `cuda:0` here); the recipe is recurrent
    (an LSTM of 256 in 2 layers before the MLP), which `train.main` runs
    with PPORecurrent; the yaml widths: 128 envs, horizon 128, episodes of
    256 (Pegs) and 128 (Gears), caps of 32 and 64."""
    from isaacgymenvs_tpu.utils.config import load_config as jload

    monkeypatch.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
    cfg, jcfg = load_config([f"task={task}"]), jload([f"task={task}"])
    for c in (cfg, jcfg):
        for k in ("sim_device", "rl_device", "device"):
            c.pop(k, None)
        c["task"].get("sim", {}).pop("device", None)
    assert cfg == jcfg
    params = cfg["train"]["params"]
    assert params["network"]["rnn"] == {"name": "lstm", "units": 256, "layers": 2, "before_mlp": True,
                                        "concat_input": True, "layer_norm": False}
    assert cfg["task"]["env"]["numEnvs"] == 128 and params["config"]["horizon_length"] == 128
    gears = "Gears" in task
    assert cfg["task"]["env"]["episodeLength"] == (128 if gears else 256)
    assert cfg["task"]["sim"]["physx"]["max_active_contacts"] == (64 if gears else 32)
    assert params["config"]["minibatch_size"] == (8 if gears else 8192)


def test_train_main_pegs_insert(tmp_path, capsys):
    """PegsInsert at 4 envs with the recipe cut to an LSTM of 16 after an
    MLP of [32, 16], horizon 8 in windows of 8, minibatches of 16 (the yaml
    asks 8,192), episodes of 6 steps: one epoch with a checkpoint that holds
    the curriculum's state (its episodes end in the epoch, so the
    population update moved `max_disp` from the yaml's 0.01, the easy bound,
    or left it there); a fresh PPORecurrent restores it bit for bit
    (parameters, Adam moments, running stats, lr, the env's task state); a
    resume for a second epoch; play."""
    task = "IndustRealTaskPegsInsert"
    run = [f"task={task}", "pipeline=cpu", "num_envs=4", f"+train_dir={tmp_path}",
           "train.params.config.horizon_length=8", "train.params.config.minibatch_size=16",
           "train.params.network.mlp.units=[32,16]", "train.params.network.rnn.units=16",
           "task.env.episodeLength=6", "task.rl.max_episode_length=6"]
    ts, metrics = ttrain.main([*run, "max_iterations=1", "train.params.config.save_frequency=1"])
    assert metrics["epoch"] == 1 and metrics["frames"] == 8 * 4
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    last = str(tmp_path / task / "nn" / f"last_{task}.pth")
    ck = load_checkpoint(last)
    assert ck["epoch"] == 1 and any(k.startswith("lstm.") for k in ck["params"])
    saved = ck["env_task_state"]
    assert set(saved) == {"max_disp", "obs_noise", "prev_rew", "success", "engaged"}
    assert torch.equal(saved["max_disp"], ts.env_state.task["max_disp"])
    assert bool(((saved["max_disp"] >= -0.01) & (saved["max_disp"] <= 0.01)).all())
    cfg = load_config(run)
    fresh = PPORecurrent(task_map[task](cfg["task"], device="cpu"), cfg["train"]["params"], seed=1)
    fts, epoch = fresh.restore(last, fresh.init())
    assert epoch == 1 and fts.lr == ts.lr
    trained = ts.optimizer.param_groups[0]["params"]
    assert all(torch.equal(a, b) for a, b in zip(fresh.network.parameters(), trained, strict=True))
    for a, b in ((fts.obs_rms, ts.obs_rms), (fts.value_rms, ts.value_rms)):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    fst, tst = fts.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"]
    assert set(fst) == set(tst) and all(torch.equal(fst[i][k], tst[i][k]) for i in tst
                                        for k in ("step", "exp_avg", "exp_avg_sq"))
    assert all(torch.equal(fts.env_state.task[k], ts.env_state.task[k]) for k in saved)
    _, resumed = ttrain.main([*run, "max_iterations=2", f"checkpoint={last}"])
    assert resumed["epoch"] == 2
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert np.isfinite(mean_ret) and "played" in capsys.readouterr().out
