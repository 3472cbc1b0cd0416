"""The port's PBT package (`isaacgymenvs_tpu_torch.pbt`) against the JAX
package's: the mutation functions under the same draws, `maybe_evolve` on
the same workspace, workspaces read across packages, the Slurm scripts;
and the port's counterparts of tests/test_pbt.py.

The JAX package draws from the module-level `random`, the port from the
`random.Random` it is given: seeding both with one seed gives both the
same stream.
"""
import os
import random

import pytest
import yaml

from isaacgymenvs_tpu import pbt as jpbt
from isaacgymenvs_tpu.pbt import launcher as jlauncher
from isaacgymenvs_tpu.pbt import mutation as jmutation
from isaacgymenvs_tpu_torch import pbt as tpbt
from isaacgymenvs_tpu_torch.pbt import launcher as tlauncher
from isaacgymenvs_tpu_torch.pbt import mutation as tmutation
from isaacgymenvs_tpu_torch.pbt.launcher import Experiment, ParamGrid, RunDescription
from isaacgymenvs_tpu_torch.pbt.mutation import mutate_discount, mutate_eps_clip, mutate_mini_epochs

MUTATIONS = {
    "train.params.config.learning_rate": "mutate_float",
    "train.params.config.grad_norm": "mutate_float_min_1",
    "train.params.config.e_clip": "mutate_eps_clip",
    "train.params.config.mini_epochs": "mutate_mini_epochs",
    "train.params.config.gamma": "mutate_discount",
    "train.params.config.tau": "mutate_discount",
}


def _params(i):
    return {
        "train.params.config.learning_rate": "3e-4" if i == 0 else 3e-4 * (i + 1),
        "train.params.config.grad_norm": 1.0 + 0.5 * i,
        "train.params.config.e_clip": 0.2,
        "train.params.config.mini_epochs": 4 + (i % 2),
        "train.params.config.gamma": 0.99,
        "train.params.config.tau": 0.95,
    }


# ---- the counterparts of tests/test_pbt.py ---------------------------------------------------

def test_mutation_functions_stay_in_bounds():
    rng = random.Random(0)
    for _ in range(100):
        assert 0.01 <= mutate_eps_clip(0.2, rng=rng) <= 0.3
        assert 1 <= mutate_mini_epochs(4, rng=rng) <= 8
        g = mutate_discount(0.99, rng=rng)
        assert 0.9 < g < 1.0
    out = tpbt.mutate({"a": 1.0, "b": "3e-4"}, {"a": "mutate_float", "b": "mutate_float"},
                      mutation_rate=1.0, change_min=1.1, change_max=1.5, rng=rng)
    assert out["a"] != 1.0
    assert isinstance(out["b"], float)


def _managers(ws, n, **kw):
    kw = {"interval_steps": 1000, "start_after": 0, "initial_delay": 0, "mutation_rate": 1.0, **kw}
    return [tpbt.PbtManager(ws, i, n, {"lr": "mutate_float"}, **kw) for i in range(n)]


def test_fs_protocol_adopts_best(tmp_path):
    managers = _managers(str(tmp_path / "pop"), 4)
    weights = {}
    for i, m in enumerate(managers):
        wp = str(tmp_path / f"w{i}.pth")
        open(wp, "w").write("weights")
        weights[i] = wp
        m.session_start_frames = 0
        m.save_checkpoint(1000, float(i * 100), {"lr": 3e-4 * (i + 1)}, wp)
    worst = managers[0]
    worst.session_start_frames = 0
    result = worst.maybe_evolve(1000, 0.0, {"lr": 3e-4}, weights[0])
    assert result is not None
    new_params, adopted = result
    assert adopted in (os.path.abspath(weights[2]), os.path.abspath(weights[3]))
    assert "lr" in new_params
    best = managers[3]
    best.session_start_frames = 0
    assert best.maybe_evolve(1000, 300.0, {"lr": 3e-4}, weights[3]) is None


def test_param_grid():
    params = ParamGrid([("seed", [1, 2]), ("pbt.policy_idx", [0, 1, 2])]).generate_params()
    assert len(params) == 6
    cmds = list(Experiment("ant_pbt", tlauncher.TRAIN_CMD + " task=Ant", params).generate_experiments())
    assert len(cmds) == 6
    assert "seed=1" in cmds[0][1] and "pbt.policy_idx=0" in cmds[0][1]
    assert cmds[0][1].startswith("-m isaacgymenvs_tpu_torch.train task=Ant")


def test_worst_policy_always_mutates_even_below_threshold(tmp_path):
    managers = _managers(str(tmp_path / "pop"), 4, rng=random.Random(1))
    weights = {}
    for i, m in enumerate(managers):
        wp = str(tmp_path / f"w{i}.pth")
        open(wp, "w").write("weights")
        weights[i] = wp
        m.session_start_frames = 0
        m.save_checkpoint(1000, 100.0 + 1e-6 * i, {"lr": 3e-4}, wp)
    worst = managers[0]
    worst.session_start_frames = 0
    result = worst.maybe_evolve(1000, 100.0, {"lr": 3e-4}, weights[0])
    assert result is not None, "a worst policy must still mutate"
    new_params, adopted = result
    assert adopted is None  # it keeps its own weights
    assert new_params["lr"] != 3e-4


def test_slurm_backend_generates_scripts(tmp_path):
    run = RunDescription("slurm_test", [Experiment("ant", tlauncher.TRAIN_CMD + " task=Ant",
                                                   ParamGrid([("seed", [1, 2])]).generate_params())])
    scripts = tlauncher.run_slurm(run, train_dir=str(tmp_path), partition="gpu", time_limit="4:00:00",
                                  submit=False)
    assert len(scripts) == 2
    body = open(scripts[0]).read()
    assert "#SBATCH --partition=gpu" in body
    assert "-m isaacgymenvs_tpu_torch.train task=Ant seed=1" in body
    assert "#SBATCH --job-name=ant_00" in body


# ---- against the JAX package -------------------------------------------------------------------

@pytest.mark.parametrize("name, x", [
    ("mutate_float", 3e-4), ("mutate_float_min_1", 1.2), ("mutate_eps_clip", 0.2),
    ("mutate_mini_epochs", 4), ("mutate_discount", 0.99),
])
def test_mutation_function_matches_jax(name, x):
    for seed in range(20):
        random.seed(seed)
        want = [jmutation.get_mutation_func(name)(x, change_min=1.1, change_max=1.5) for _ in range(5)]
        rng = random.Random(seed)
        got = [tmutation.get_mutation_func(name)(x, change_min=1.1, change_max=1.5, rng=rng) for _ in range(5)]
        assert got == want


def test_mutate_matches_jax():
    for seed in range(20):
        random.seed(seed)
        want = jmutation.mutate(_params(0), MUTATIONS, 0.5, 1.1, 1.5)
        got = tmutation.mutate(_params(0), MUTATIONS, 0.5, 1.1, 1.5, random.Random(seed))
        assert got == want


PBT_KW = dict(interval_steps=1000, start_after=0, initial_delay=0, mutation_rate=0.5,
              replace_fraction_worst=0.25, replace_fraction_best=0.5)
CASES = {
    # objectives per policy, the deciding policy
    "above_the_worst": ([0.0, 100.0, 200.0, 300.0], 1),
    "worst_within_threshold": ([100.0, 100.001, 100.002, 100.003], 0),
    "worst_beyond_threshold": ([0.0, 100.0, 200.0, 300.0], 0),
}


def _write_population(ws, tmp_path, objectives, manager_cls):
    for i, obj in enumerate(objectives):
        wp = tmp_path / f"weights_{i}.pth"
        wp.write_text(f"weights of {i}")
        manager_cls(ws, i, len(objectives), MUTATIONS, **PBT_KW).save_checkpoint(2000, obj, _params(i), str(wp))


def _decide(manager, objectives, idx, tmp_path):
    manager.session_start_frames = 0
    return manager.maybe_evolve(2000, objectives[idx], _params(idx), str(tmp_path / f"weights_{idx}.pth"))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_maybe_evolve_matches_jax_on_a_jax_workspace(tmp_path, case, seed):
    """The same donor, the same new params and the same weights path as
    JAX's manager on the workspace JAX's managers wrote."""
    objectives, idx = CASES[case]
    ws = str(tmp_path / "ws")
    _write_population(ws, tmp_path, objectives, jpbt.PbtManager)
    random.seed(seed)
    want = _decide(jpbt.PbtManager(ws, idx, len(objectives), MUTATIONS, **PBT_KW), objectives, idx, tmp_path)
    got = _decide(tpbt.PbtManager(ws, idx, len(objectives), MUTATIONS, rng=random.Random(seed), **PBT_KW),
                  objectives, idx, tmp_path)
    assert got == want
    if case == "above_the_worst":
        assert got is None
    elif case == "worst_within_threshold":
        assert got is not None and got[1] is None  # mutates, keeps its own weights
    else:
        # a top policy's weights (replace_fraction_best 0.5 of 4: the best two)
        assert got is not None and got[1] in (str(tmp_path / "weights_2.pth"), str(tmp_path / "weights_3.pth"))


@pytest.mark.parametrize("seed", [0, 3])
def test_jax_reads_a_workspace_the_port_wrote(tmp_path, seed):
    objectives, idx = CASES["worst_beyond_threshold"]
    ws = str(tmp_path / "ws")
    _write_population(ws, tmp_path, objectives, tpbt.PbtManager)
    assert sorted(os.listdir(ws)) == [f"policy_{i:02d}" for i in range(4)]
    rec = yaml.safe_load(open(os.path.join(ws, "policy_02", "000002.yaml")))
    assert set(rec) == {"iteration", "frames", "true_objective", "params", "checkpoint", "timestamp"}
    jm = jpbt.PbtManager(ws, idx, 4, MUTATIONS, **PBT_KW)
    tm = tpbt.PbtManager(ws, idx, 4, MUTATIONS, rng=random.Random(seed), **PBT_KW)
    assert jm._load_population(2) == tm._load_population(2)
    random.seed(seed)
    want = _decide(jm, objectives, idx, tmp_path)
    assert _decide(tm, objectives, idx, tmp_path) == want
    assert want is not None and want[1] in (str(tmp_path / "weights_2.pth"), str(tmp_path / "weights_3.pth"))


def test_slurm_scripts_match_jax_but_the_module(tmp_path):
    grid = [("seed", [1, 2]), ("pbt.policy_idx", [0, 1])]
    kw = dict(python="/usr/bin/python3", partition="gpu", time_limit="4:00:00", setup="module load cuda",
              submit=False)
    jrun = jlauncher.RunDescription("pop", [jlauncher.Experiment(
        "ant", "train.py task=Ant pbt=pbt_default", jlauncher.ParamGrid(grid).generate_params())])
    trun = RunDescription("pop", [Experiment(
        "ant", tlauncher.TRAIN_CMD + " task=Ant pbt=pbt_default", ParamGrid(grid).generate_params())])
    want = jlauncher.run_slurm(jrun, train_dir=str(tmp_path / "jax"), **kw)
    got = tlauncher.run_slurm(trun, train_dir=str(tmp_path / "port"), **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        g_text = open(g).read().replace(str(tmp_path / "port"), str(tmp_path / "jax"))
        assert g_text.replace(tlauncher.TRAIN_CMD, "train.py") == open(w).read()
        assert tlauncher.TRAIN_CMD in g_text
