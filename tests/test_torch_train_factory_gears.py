"""`train.main task=FactoryTaskGears pipeline=cpu` at 4 envs on both of
its routes: the kernel (its plain version here) by default, and the eager
engine under `task.sim.use_fused=False`: train with a checkpoint, a fresh
PPO restores it bit for bit, a resume and play."""
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.learn import PPO
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint
from isaacgymenvs_tpu_torch.utils.config import load_config

torch.set_num_threads(1)


@pytest.mark.parametrize("route", ["kernel", "eager"])
def test_train_main_factory_gears(route, tmp_path, capsys):
    """Two epochs of horizon 4 (minibatch 8 of the batch of 16; the MLP cut
    to [32, 16]) with a checkpoint each, episodes of 4 steps; a fresh PPO
    restores the last checkpoint bit for bit (parameters, Adam moments,
    running statistics, the env's task state); a resume for a third epoch;
    play. The template's reward and observation are zero."""
    task = "FactoryTaskGears"
    run = [f"task={task}", "pipeline=cpu", "num_envs=4", f"+train_dir={tmp_path}",
           "train.params.config.horizon_length=4", "train.params.config.minibatch_size=8",
           "train.params.network.mlp.units=[32,16]", "task.env.episodeLength=4"]
    if route == "eager":
        run.append("task.sim.use_fused=False")
    ts, metrics = ttrain.main([*run, "max_iterations=2", "train.params.config.save_frequency=1"])
    assert metrics["epoch"] == 2 and metrics["frames"] == 2 * 4 * 4
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    last = str(tmp_path / task / "nn" / f"last_{task}.pth")
    ck = load_checkpoint(last)
    assert ck["epoch"] == 2 and torch.equal(ck["env_task_state"]["q_ref"], ts.env_state.task["q_ref"])
    cfg = load_config(run)
    env = task_map[task](cfg["task"], device="cpu")
    assert env.physics_route == route
    fresh = PPO(env, cfg["train"]["params"], seed=1)
    fts, epoch = fresh.restore(last, fresh.init())
    assert epoch == 2 and fts.lr == ts.lr
    trained = ts.optimizer.param_groups[0]["params"]
    assert all(torch.equal(a, b) for a, b in zip(fresh.network.parameters(), trained, strict=True))
    for a, b in ((fts.obs_rms, ts.obs_rms), (fts.value_rms, ts.value_rms)):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    fst, tst = fts.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"]
    assert set(fst) == set(tst) and all(torch.equal(fst[i][k], tst[i][k]) for i in tst
                                        for k in ("step", "exp_avg", "exp_avg_sq"))
    assert torch.equal(fts.env_state.task["q_ref"], ts.env_state.task["q_ref"])
    _, resumed = ttrain.main([*run, "max_iterations=3", f"checkpoint={last}"])
    assert resumed["epoch"] == 3
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert mean_ret == 0.0 and "played" in capsys.readouterr().out
