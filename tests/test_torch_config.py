"""The port's config loader against the JAX package's: the same composed
dict for the tasks the port carries, apart from the device flags."""
import os

import pytest

from isaacgymenvs_tpu.utils.config import load_config as jax_load_config
from isaacgymenvs_tpu_torch.utils import config as tconfig

DEVICE_FLAGS = ("sim_device", "rl_device")
OVERRIDES = ["num_envs=64", "train.params.config.minibatch_size=1024", "max_iterations=7", "experiment=X"]


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["defaults", "overrides"])
@pytest.mark.parametrize("task", ["Ant", "Cartpole", "Ingenuity", "Quadcopter", "BallBalance"])
def test_load_config_matches_jax(task, overrides):
    args = [f"task={task}", *overrides]
    jcfg, tcfg = jax_load_config(args), tconfig.load_config(args)
    assert tcfg["sim_device"] == "cuda:0" and tcfg["rl_device"] == "cuda:0"
    strip = lambda c: {k: v for k, v in c.items() if k not in DEVICE_FLAGS}
    assert strip(tcfg) == strip(jcfg)
    if overrides:
        assert tcfg["task"]["env"]["numEnvs"] == 64
        conf = tcfg["train"]["params"]["config"]
        assert (conf["minibatch_size"], conf["max_epochs"], conf["name"]) == (1024, 7, "X")


@pytest.mark.parametrize("args", [["task=Humanoid"], ["task=Humanoid", "train=HumanoidSAC"],
                                  ["task=Ant", "train=AntSAC"],
                                  ["task=AnymalTerrain", "train=AnymalTerrainPPO_LSTM"]],
                         ids=["HumanoidPPO", "HumanoidSAC", "AntSAC", "AnymalTerrainPPO_LSTM"])
def test_recipes_match_jax(args):
    """The train yamls of this port's SAC and recurrent recipes (the last
    two are built on `defaults:`) compose to the JAX package's dicts."""
    jcfg, tcfg = jax_load_config(args), tconfig.load_config(args)
    strip = lambda c: {k: v for k, v in c.items() if k not in DEVICE_FLAGS}
    assert strip(tcfg)["train"] == strip(jcfg)["train"] and tcfg["task"]["env"] == jcfg["task"]["env"]


def test_cfg_dir_is_the_ports_own():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tconfig.__file__)))
    assert tconfig.cfg_dir() == os.path.join(pkg, "cfg")
    assert os.path.exists(os.path.join(tconfig.cfg_dir(), "task", "Cartpole.yaml"))


def test_unknown_task_raises():
    # a task the port has no yaml for (every name of the JAX task_map has one)
    with pytest.raises(FileNotFoundError, match="NoSuchTask"):
        tconfig.load_config(["task=NoSuchTask"])


def test_resolvers_and_overrides():
    cfg = {"a": {"b": 3, "c": "${.b}", "d": "${..top}"}, "top": "x",
           "e": "${resolve_default:7,${a.missing}}", "f": "${if:${eq:${top},x},then,else}",
           "g": "${contains:x,${top}yz}"}
    cfg["a"]["missing"] = ""
    out = tconfig.resolve(tconfig.apply_overrides(cfg, ["a.b=5", "+new.key=1.5"]))
    assert out["a"] == {"b": 5, "c": 5, "d": "x", "missing": ""}
    assert (out["e"], out["f"], out["g"], out["new"]["key"]) == (7, "then", True, 1.5)
    with pytest.raises(ValueError):
        tconfig.apply_overrides({}, ["novalue"])


@pytest.mark.parametrize("task", ["AntSAC", "HumanoidSAC"])
def test_sac_task_variants_resolve_to_sac(task):
    """tests/test_config.py:72-74 on the port: `task=AntSAC` (and
    `HumanoidSAC`) finds the thin task yaml, which aliases the base class
    through `name:`, and falls back to train/<task>.yaml for the recipe:
    SAC, the same composed dict as the JAX package's."""
    jcfg, tcfg = jax_load_config([f"task={task}"]), tconfig.load_config([f"task={task}"])
    assert tcfg["train"]["params"]["algo"]["name"] == "sac"
    assert tcfg["task"]["name"] == task[:-3]
    strip = lambda c: {k: v for k, v in c.items() if k not in DEVICE_FLAGS}
    assert strip(tcfg) == strip(jcfg)


@pytest.mark.parametrize("task", ["FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace", "FactoryTaskNutBoltScrew"])
def test_nut_bolt_configs_match_jax(task):
    """The nut-bolt yamls (task on FactoryEnvNutBolt on FactoryBase, and the
    PPO recipes) compose to the JAX package's dicts, with the operating
    point of the yamls: 128 envs, dt 1/60 with 2 substeps, 16 position
    iterations, a cap of 16, minibatch 512 over 8 mini-epochs."""
    jcfg, tcfg = jax_load_config([f"task={task}"]), tconfig.load_config([f"task={task}"])
    strip = lambda c: {k: v for k, v in c.items() if k not in DEVICE_FLAGS}
    assert strip(tcfg) == strip(jcfg)
    t, c = tcfg["task"], tcfg["train"]["params"]["config"]
    assert (t["env"]["numEnvs"], t["sim"]["substeps"], t["sim"]["physx"]["num_position_iterations"],
            t["sim"]["physx"]["max_active_contacts"]) == (128, 2, 16, 16)
    assert (c["minibatch_size"], c["mini_epochs"], c["horizon_length"]) == (512, 8, 128 if "Screw" in task else 120)
