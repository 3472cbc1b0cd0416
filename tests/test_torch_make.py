"""The port's `make()` against the JAX package's: the same task config,
the same number of envs and the same class, variant names resolved
through their yaml's `name:`."""
import pytest
import torch

import isaacgymenvs_tpu as jpkg
import isaacgymenvs_tpu_torch as tpkg
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root

torch.set_num_threads(1)


@pytest.mark.parametrize("task, num_envs, overrides, cls", [
    ("Cartpole", 8, {"task.env.episodeLength": 50}, "Cartpole"),
    ("AntSAC", 4, {}, "Ant"),
    ("HumanoidAMPHands", 4, {}, "HumanoidAMP"),
])
def test_make_matches_jax(monkeypatch, task, num_envs, overrides, cls):
    monkeypatch.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
    want = jpkg.make(seed=3, task=task, num_envs=num_envs, sim_device="cpu", rl_device="cpu", **overrides)
    got = tpkg.make(seed=3, task=task, num_envs=num_envs, sim_device="cpu", rl_device="cpu", **overrides)
    assert type(got).__name__ == type(want).__name__ == cls
    assert got.cfg == want.cfg
    assert got.num_envs == want.num_envs == num_envs
    assert (got.num_obs, got.num_acts) == (want.num_obs, want.num_acts)
    assert got.device.type == "cpu"
    for k, v in overrides.items():
        assert got.cfg["env"][k.split(".")[-1]] == v
    _, obs = got.reset(0)
    assert obs.shape == (num_envs, got.num_obs)


def test_make_with_a_task_config():
    cfg = tpkg.make(task="Cartpole", num_envs=4, sim_device="cpu").cfg
    env = tpkg.make(task="Cartpole", sim_device="cpu", cfg=cfg)
    assert env.cfg is cfg and env.num_envs == 4


def test_make_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.make(task="Cartpole", num_envs=4)
