"""The port's checkpoints and its `train` entry point, on the CPU.

The train tests of the other task families sit in files of their own
(tests/test_torch_train_<task>.py), so that the test workers, which take
whole files, share them out."""
import os
import pickle

import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.learn import PPO
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

TRAIN = {"network": {"mlp": {"units": [16, 16], "activation": "elu"}},
         "config": {"horizon_length": 4, "minibatch_size": 16, "mini_epochs": 2, "critic_coef": 4,
                    "reward_shaper": {"scale_value": 0.1}}}


def _agent(task="Cartpole", n=8, seed=0):
    cfg = {"env": {"numEnvs": n, "clipObservations": 5.0, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    return PPO(task_map[task](cfg, device="cpu"), TRAIN, seed=seed)


def _inputs(agent, seed):
    rng = np.random.RandomState(seed)
    cfg, n = agent.cfg, agent.env.num_envs
    noise = torch.tensor(rng.normal(size=(cfg.horizon_length, n, agent.env.num_acts)).astype(np.float32))
    perms = torch.tensor(np.stack([rng.permutation(agent.batch_size) for _ in range(cfg.mini_epochs)]))
    return noise, perms


def _learnable(agent, ts):
    """Everything a checkpoint carries, as a flat dict of tensors and floats."""
    out = {f"params/{k}": v.clone() for k, v in agent.network.state_dict().items()}
    for name, rms in (("obs_rms", ts.obs_rms), ("value_rms", ts.value_rms)):
        out.update({f"{name}/{f}": getattr(rms, f).clone() for f in ("mean", "var", "count")})
    for i, st in ts.optimizer.state_dict()["state"].items():
        out.update({f"adam/{i}/{k}": v.clone() for k, v in st.items()})
    out["lr"] = ts.lr
    return out


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k], k


@pytest.mark.parametrize("task", ["Cartpole", "Ant", "BallBalance"])
def test_checkpoint_roundtrip_is_bit_equal_and_resumes(tmp_path, task):
    """save -> restore into a fresh agent gives back the parameters, Adam
    moments, running stats, lr and env task state bit for bit, and the epoch
    after a resume equals the uninterrupted one given the same noise and
    shuffles."""
    agent = _agent(task)
    ts = agent.init()
    ts, _ = agent.train_epoch(ts, *_inputs(agent, 1))
    path = str(tmp_path / "nn" / "ck.pth")
    agent.save(path, ts, epoch=1, frames=32)
    saved = _learnable(agent, ts)
    assert any(k.startswith("adam/") and float(v.abs().sum()) > 0 for k, v in saved.items() if "exp_avg" in k)

    other = _agent(task, seed=9)  # other weights, other env state
    ots, epoch = other.restore(path, other.init())
    assert epoch == 1
    _assert_same(_learnable(other, ots), saved)
    assert len(ots.env_state.task) == len(ts.env_state.task)
    for a, b in zip(ots.env_state.task, ts.env_state.task):
        assert torch.equal(a, b)

    # the resumed epoch: the env state is not in the checkpoint, so give it over
    ots.env_state, ots.obs = ts.env_state, ts.obs
    ots.ep_return, ots.ep_len = ts.ep_return, ts.ep_len
    noise, perms = _inputs(agent, 2)
    reset_draws = ts.env_state.rng.get_state()
    ts2, m2 = agent.train_epoch(ts, noise, perms)
    ots.env_state.rng.set_state(reset_draws)  # the same generator object: rewind it
    ots2, om2 = other.train_epoch(ots, noise, perms)
    assert m2 == om2
    _assert_same(_learnable(other, ots2), _learnable(agent, ts2))


def test_load_checkpoint_refuses_a_pickled_callable(tmp_path):
    path = str(tmp_path / "evil.pth")
    with open(path, "wb") as f:
        pickle.dump({"params": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(path)
    torch.save({"fn": print}, path)
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(path)
    good = str(tmp_path / "sub" / "good.pth")
    save_checkpoint(good, {"a": torch.arange(3), "n": 7, "t": (torch.ones(2),)})
    ck = load_checkpoint(good)
    assert ck["n"] == 7 and torch.equal(ck["a"], torch.arange(3)) and not os.path.exists(good + ".tmp")


def test_override_sigma_and_act():
    agent = _agent()
    ts = agent.override_sigma(agent.init(), 0.5)
    assert torch.allclose(agent.network.log_sigma, torch.full((1,), float(np.log(0.5))))
    obs = ts.obs
    mu = agent.act(ts, obs)
    assert torch.equal(mu, agent.act(ts, obs)) and mu.shape == (8, 1)
    g = torch.Generator().manual_seed(0)
    assert not torch.equal(agent.act(ts, obs, deterministic=False, generator=g), mu)


def test_train_main_writes_run_and_plays(tmp_path, capsys):
    run = ["task=Cartpole", "pipeline=cpu", "num_envs=16", f"+train_dir={tmp_path}"]
    ts, metrics = ttrain.main([*run, "max_iterations=2", "train.params.config.save_frequency=1"])
    assert metrics["epoch"] == 2 and metrics["frames"] == 2 * 16 * 16
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    run_dir = tmp_path / "Cartpole"
    assert (run_dir / "config.yaml").exists() and (run_dir / "summaries").is_dir()
    names = sorted(p.name for p in (run_dir / "nn").iterdir())
    assert names == ["last_Cartpole.pth", "last_Cartpole_ep_1.pth", "last_Cartpole_ep_2.pth"]
    # resume: one more epoch from the checkpoint of epoch 2
    last = str(run_dir / "nn" / "last_Cartpole.pth")
    _, resumed = ttrain.main([*run, "max_iterations=3", f"checkpoint={last}"])
    assert resumed["epoch"] == 3
    # play from the checkpoint, with the sigma override
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}", "sigma=0.3"])
    assert np.isfinite(mean_ret) and "played" in capsys.readouterr().out


def train_main_resume_play(tmp_path, capsys, task, horizon):
    """`train.main task=<task> pipeline=cpu` at 16 envs: two epochs with a
    checkpoint each, a resume for a third, and play from the checkpoint (the
    procedural tasks' train tests, one file per task so that workers share
    them)."""
    run = [f"task={task}", "pipeline=cpu", "num_envs=16", f"+train_dir={tmp_path}",
           "train.params.config.minibatch_size=128"]
    ts, metrics = ttrain.main([*run, "max_iterations=2", "train.params.config.save_frequency=1"])
    assert metrics["epoch"] == 2 and metrics["frames"] == 2 * horizon * 16
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    names = sorted(p.name for p in (tmp_path / task / "nn").iterdir())
    assert names == [f"last_{task}.pth", f"last_{task}_ep_1.pth", f"last_{task}_ep_2.pth"]
    last = str(tmp_path / task / "nn" / f"last_{task}.pth")
    ck = load_checkpoint(last)
    assert ck["epoch"] == 2 and ck["frames"] == metrics["frames"]
    for a, b in zip(ck["env_task_state"], ts.env_state.task):  # the integrated targets travel with it
        assert torch.equal(a, b)
    _, resumed = ttrain.main([*run, "max_iterations=3", f"checkpoint={last}"])
    assert resumed["epoch"] == 3
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert np.isfinite(mean_ret) and "played" in capsys.readouterr().out


def test_train_reports_frames_to_the_env():
    agent = _agent("Cartpole")
    seen = []
    agent.env.set_train_info = lambda frames, *a, **k: seen.append(frames)
    agent.train(max_epochs=3, log_every=100)
    assert seen == [32, 64, 96]


def test_train_main_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["task=Cartpole", "num_envs=16", "max_iterations=1", f"+train_dir={tmp_path}"])
    assert not (tmp_path / "Cartpole").exists()


# what each option raises: capture_video is not ported yet; multi_gpu is, and
# without a launcher's process-group variables it raises naming them, as the
# JAX package's train.py does
RAISES = {"multi_gpu": (RuntimeError, "multi_gpu=True but no process-group env vars"),
          "capture_video": (SystemExit, "not ported yet.*capture_video")}


@pytest.mark.parametrize("override, named", [
    ("multi_gpu=True", "multi_gpu"),
    ("capture_video=True", "capture_video"),
])
def test_train_main_exits_for_unported_options(override, named):
    exc, match = RAISES[named]
    with pytest.raises(exc, match=match):
        ttrain.main(["task=Cartpole", "pipeline=cpu", "num_envs=16", override])


def test_train_main_unknown_task():
    # a task the port has no yaml for (every name of the JAX task_map has one)
    with pytest.raises(FileNotFoundError):
        ttrain.main(["task=NoSuchTask", "pipeline=cpu"])


def test_cartpole_learns_on_the_cpu():
    """The learning smoke of tests/test_ppo.py on the port: 128 envs, 35
    epochs; an untrained policy returns ~1-3, a learning one passes 10."""
    cfg = {"env": {"numEnvs": 128, "clipObservations": 5.0, "clipActions": 1.0},
           "sim": {"dt": 1 / 60, "substeps": 2}}
    train = {"network": {"mlp": {"units": [32, 32], "activation": "elu"}},
             "config": {"horizon_length": 16, "minibatch_size": 2048, "mini_epochs": 8, "critic_coef": 4,
                        "reward_shaper": {"scale_value": 0.1}, "max_epochs": 35}}
    agent = PPO(task_map["Cartpole"](cfg, device="cpu"), train, seed=3)
    _, metrics = agent.train(log_every=100)
    assert metrics["mean_episode_return"] > 10.0
    assert np.isfinite(metrics["kl"]) and np.isfinite(metrics["a_loss"])
