"""The port's two-arm AllegroKuka model against the JAX package, on the
CPU: the plain step on the task's contact states and reset plus env steps
(nv 52, 56 pair rows, every row in the solve); and the port's
counterparts of tests/test_allegro_kuka_two_arms.py. The models, hooks and
configs of both two-arm tasks are held in tests/test_torch_allegro_kuka.py.

The JAX package's `fused_supported` refuses the two-arm model for its TPU
VMEM budget (168 Delassus rows, about 32 MB of residents against 20 MiB),
so a JAX env of it steps the eager engine even with `sim.use_fused`. The
port has no eager engine and runs the kernel, whose plain version is JAX's
fused math: the env-step test sets `_fused_cap_cache = True` on its JAX env
instance (an instance attribute, no edit of the JAX package) so that JAX
steps that fused math (`use_pallas=False` on the CPU). JAX's fused jnp
step at nv 52 is slow on the CPU: the comparisons run at 4 envs.
Tolerances as in tests/test_torch_allegro_kuka.py.
"""
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from test_torch_allegro_kuka import both, env_steps_match_jax, plain_step_matches_jax

torch.set_num_threads(1)

TASK = "AllegroKukaTwoArmsReorientation"


@pytest.fixture(autouse=True)
def _jax_assets(monkeypatch):
    monkeypatch.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())


def test_plain_step_matches_jax():
    """Two arms, 4 states: the cube on the highest fingertip of either arm
    or on the wide table."""
    plain_step_matches_jax(TASK, 4)


def test_reset_and_env_steps_match_jax():
    """Reset and three env steps against the JAX env's step through its
    fused math (`_fused_cap_cache = True` on the JAX instance: its
    `fused_supported` refuses the model for TPU VMEM only)."""
    from isaacgymenvs_tpu.tasks.allegro_kuka_two_arms import AllegroKukaTwoArmsReorientation as JTwoArms

    jenv, tenv = both(TASK)
    assert isinstance(jenv, JTwoArms)
    jenv._fused_cap_cache = True
    env_steps_match_jax(TASK, jenv, tenv)


# ---- tests/test_allegro_kuka_two_arms.py, the port's counterparts --------------------

def make(name=TASK, num_envs=4, **env_kw):
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={name}", f"num_envs={num_envs}"])["task"]
    cfg["env"].update(env_kw)
    return task_map[name](cfg, device="cpu")


def test_contract_and_cube_rests_on_wide_table():
    """196 observations, 46 actions; after 25 zero-action steps the cube
    lies within 5e-3 of its rest height on the wide table in every env (the
    bar chip_smoke.py holds the kernel to at 8,192 envs, PERF.md)."""
    from isaacgymenvs_tpu_torch.tasks.allegro_kuka import OBJ_SIZE
    from isaacgymenvs_tpu_torch.tasks.allegro_kuka_two_arms import TABLE_TOP

    env = make(num_envs=8)
    assert env.num_obs == 196 and env.num_acts == 46
    state, obs = env.reset(0)
    assert obs.shape == (8, 196)
    for _ in range(25):
        state, obs, rew, done, ex = env.step(state, torch.zeros(8, 46))
    assert bool(torch.isfinite(obs).all())
    cz = state.sim.q[:, env.oq + 2]
    assert float((cz - (TABLE_TOP + OBJ_SIZE / 2)).abs().max()) < 5e-3, cz
    assert "true_objective" in ex


def test_goal_biased_toward_one_arm():
    """Goals gather about x = -/+0.75, within 0.2 (the handover bias)."""
    env = make(num_envs=64)
    state, obs = env.reset(1)
    gx = state.task["goal_pos"][:, 0].numpy()
    assert (np.abs(gx) > 0.5).all() and (np.abs(gx) < 0.95).all(), gx
    assert (gx > 0).any() and (gx < 0).any()


def test_fingertip_reward_not_gated_on_lifting():
    """The eight fingertips' approach pays while the cube is lifted (the
    single arm's stops)."""
    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics

    env = make(num_envs=1)
    state, obs = env.reset(2)
    q, qd = state.sim.q, state.sim.qd
    kin = forward_kinematics(env.model, q, qd)
    task = {**state.task, "lifted": torch.tensor([True]), "closest_tip_dist": torch.full((1, 8), 10.0),
            "closest_kp_dist": torch.zeros(1)}
    r, _, new = env.reward_done(obs, q, qd, kin, None, task, torch.zeros(1, 46), torch.tensor([1]))
    assert float(r) > 1000.0, float(r)
    assert set(new["rew_terms"]) == {"fingertip_delta_rew", "lifting_rew", "lift_bonus_rew", "keypoint_rew",
                                     "bonus_rew"}


def test_regrasping_two_arms_contract():
    env = make("AllegroKukaTwoArmsRegrasping")
    assert env.num_obs == 169 and env.num_keypoints == 1
    state, obs = env.reset(3)
    for _ in range(5):
        state, obs, rew, done, ex = env.step(state, torch.zeros(4, 46))
    assert bool(torch.isfinite(obs).all())


def test_two_arm_resets_ignore_the_bank(tmp_path):
    """With loadInitialStates both packages load the bank (its shape
    checked) and reset every env from fresh draws, never a bank row (the
    JAX two-arm task's reset does not read it)."""
    import jax

    bank = str(tmp_path / "bank.npz")
    rng = np.random.RandomState(0)
    np.savez(bank, q=rng.normal(size=(6, 53)).astype(np.float32), qd=rng.normal(size=(6, 52)).astype(np.float32))
    jenv, tenv = both(TASK, ("task.env.loadInitialStates=True", f"task.env.loadStatesFile={bank}"))
    assert tenv.initial_q.shape == (6, 53) and jenv.initial_q.shape == (6, 53)
    assert tenv.init_draws(torch.Generator().manual_seed(0), 4)[5] is None
    data = np.load(bank)["q"]
    for q in (tenv.reset(0)[0].sim.q.numpy(), np.asarray(jenv.reset(jax.random.PRNGKey(0))[0].sim.q)):
        assert all(np.abs(data - q[e][None]).max(-1).min() > 0.1 for e in range(4))
