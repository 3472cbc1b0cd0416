"""The port's HRL learner (learn/hrl.py): the four tests of tests/test_hrl.py
on the port's Cartpole, and the LLC action and one macro step against the
JAX package's HRL on converted weights.

The JAX side reaches the bundled Cartpole through $ISAACGYMENVS_TPU_ASSETS
and steps it with its fused physics math (`use_fused`), as the port does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.learn import HRL, PPO
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _env(n=16):
    return task_map["Cartpole"]({"env": {"numEnvs": n, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}},
                                device="cpu")


TP = {
    "algo": {"name": "hrl_continuous"},
    "network": {"mlp": {"units": [32, 32]}},
    "config": {
        "horizon_length": 4,
        "minibatch_size": 32,
        "mini_epochs": 2,
        "llc_steps": 3,
        "latent_dim": 5,
        "llc_network": {"mlp": {"units": [16]}},
    },
}


def test_hrl_latent_action_space_and_macro_steps():
    env = _env()
    agent = HRL(env, TP, seed=0)
    ts = agent.init()
    # the high-level policy emits latents, not env actions
    mu, log_sigma, v = agent.network(ts.obs)
    assert mu.shape == (16, 5)
    # one macro transition advances the env llc_steps times
    p0 = ts.env_state.progress.clone()
    es, obs, rew, done, ex = agent.env_step(ts.env_state, ts.obs, torch.zeros(16, 5))
    assert bool(((es.progress - p0 == 3) | done).all())
    assert rew.shape == (16,) and "time_outs" in ex
    # the frozen LLC is in no optimizer and takes no gradient
    assert not any(p.requires_grad for p in agent.llc_network.parameters())
    opt = {id(p) for g in ts.optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in opt for p in agent.llc_network.parameters())


def test_hrl_llc_checkpoint_roundtrip(tmp_path):
    """A PPO checkpoint of Cartpole (obs 4) loads as a `concat` LLC on 2
    observation entries and a latent of 2."""
    env = _env()
    llc_tp = {"network": {"mlp": {"units": [16]}},
              "config": {"horizon_length": 4, "minibatch_size": 32, "mini_epochs": 1}}
    llc = PPO(env, llc_tp, seed=1)
    llc_ts = llc.init()
    path = str(tmp_path / "llc.pth")
    llc.save(path, llc_ts)
    tp = {k: (dict(v) if isinstance(v, dict) else v) for k, v in TP.items()}
    tp["config"] = dict(TP["config"])
    tp["config"].update(llc_checkpoint=path, latent_dim=2, llc_obs_dim=2, llc_network={"mlp": {"units": [16]}},
                        llc_style="concat")
    agent = HRL(env, tp, seed=0)
    for k, v in llc.network.state_dict().items():
        assert torch.equal(agent.llc_network.state_dict()[k], v), k
    ts = agent.init()
    es, obs, rew, done, ex = agent.env_step(ts.env_state, ts.obs, torch.zeros(16, 2))
    assert bool(torch.isfinite(rew).all())


def test_hrl_train_epoch_runs():
    env = _env()
    agent = HRL(env, TP, seed=0)
    ts = agent.init()
    ts, metrics = agent.train_epoch(ts)
    assert np.isfinite(metrics["kl"]) and np.isfinite(metrics["a_loss"])


def test_amp_latent_llc_is_style_conditioned():
    """The default LLC is conditioned on the latent's direction, which is
    put on the unit sphere first: z and 10 z give the same action."""
    env = _env(4)
    agent = HRL(env, TP, seed=0)
    obs = torch.ones(4, env.num_obs)
    z1 = torch.zeros(4, 5)
    z1[:, 0] = 1.0
    z2 = torch.zeros(4, 5)
    z2[:, 1] = 1.0
    a1, a2 = agent._llc_action(obs, z1), agent._llc_action(obs, z2)
    assert not torch.allclose(a1, a2)
    torch.testing.assert_close(agent._llc_action(obs, 10.0 * z1), a1, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def pair():
    """The JAX package's HRL and the port's on Cartpole (8 envs), the LLC
    and the high-level network carried across from the JAX weights."""
    from isaacgymenvs_tpu.learn import HRL as JHRL
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.convert import actor_critic_from_flax

    cfg = {"env": {"numEnvs": 8, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Cartpole"]({"env": dict(cfg["env"]), "sim": {**cfg["sim"], "use_fused": True}})
    tenv = task_map["Cartpole"]({k: dict(v) for k, v in cfg.items()}, device="cpu")
    tp = {**TP, "config": {**TP["config"], "llc_network": {"mlp": {"units": [16, 8]}}, "llc_latent_units": 6}}
    jagent, tagent = JHRL(jenv, tp, seed=0), HRL(tenv, tp, seed=0)
    tagent.llc_network.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, jagent.llc_params)))
    return jagent, tagent


def test_llc_action_matches_jax(pair):
    """The `amp_latent` LLC's action on the same weights, observations and
    latents (of several lengths, so the normalization acts): 1e-6."""
    jagent, tagent = pair
    rng = np.random.RandomState(0)
    obs = rng.normal(size=(8, 4)).astype(np.float32)
    z = rng.normal(size=(8, 5)).astype(np.float32) * rng.uniform(0.1, 10.0, (8, 1)).astype(np.float32)
    want = jagent._llc_action(jnp.asarray(obs), jnp.asarray(z))
    np.testing.assert_allclose(tagent._llc_action(torch.tensor(obs), torch.tensor(z)).numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def test_macro_step_matches_jax(pair):
    """One macro step (3 env steps of the LLC under a clamped latent) from
    the JAX reset state: q, qd, obs and the mean reward within 1e-5 (plus
    1e-5 relative: the poles spin up to 20 rad/s), the OR of the dones and
    progress equal."""
    jagent, tagent = pair
    jstate, jobs = jagent.env.reset(jax.random.PRNGKey(3))
    tstate, _ = tagent.env.reset(0)
    t = lambda a: torch.tensor(np.asarray(a))
    tstate.sim = SimState(q=t(jstate.sim.q), qd=t(jstate.sim.qd))
    latent = np.random.RandomState(1).normal(0, 2.0, (8, 5)).astype(np.float32)
    js, jo, jr, jd, _ = jagent.env_step(jstate, jobs, jnp.asarray(latent))
    ts_, to, tr, td, _ = tagent.env_step(tstate, t(jobs), torch.tensor(latent))
    np.testing.assert_allclose(ts_.sim.q.numpy(), np.asarray(js.sim.q), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts_.sim.qd.numpy(), np.asarray(js.sim.qd), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts_.progress.numpy(), np.asarray(js.progress))
