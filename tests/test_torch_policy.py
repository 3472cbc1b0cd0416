"""The port's policy, running stats and rollout against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.learn import networks as jnet
from isaacgymenvs_tpu.learn import running_stats as jrs
from isaacgymenvs_tpu.learn.ppo import _gaussian_logp as jax_logp
from isaacgymenvs_tpu_torch.convert import actor_critic_from_flax
from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.learn import networks as tnet
from isaacgymenvs_tpu_torch.learn import running_stats as trs
from isaacgymenvs_tpu_torch.learn.ppo import PPO, _gaussian_logp
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

N, OBS, ACT = 4, 60, 8


def _flat(tree, prefix=""):
    """A nested params tree as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if hasattr(v, "items") else {key: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def flax_policy():
    net = jnet.ActorCritic(num_actions=ACT, units=(256, 128, 64), act="elu")
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, OBS)))
    # a non-zero log-sigma so the sigma path is exercised
    params["params"]["log_sigma"] = jnp.linspace(-0.5, 0.3, ACT)
    port = tnet.ActorCritic(OBS, ACT, units=(256, 128, 64))
    port.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return net, params, port


def test_actor_critic_from_flax(flax_policy):
    net, params, port = flax_policy
    obs = np.random.RandomState(0).normal(size=(32, OBS)).astype(np.float32)
    mu, ls, v = net.apply(params, jnp.asarray(obs))
    tmu, tls, tv = (x.detach() for x in port(torch.tensor(obs)))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=1e-5)
    np.testing.assert_allclose(tls.numpy(), np.asarray(ls), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), atol=1e-5)
    # the flattened form converts the same way
    sd = actor_critic_from_flax(_flat(params))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(sd[k], v)


def test_gaussian_logp():
    rng = np.random.RandomState(1)
    x, mu, ls = (rng.normal(size=(16, ACT)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        _gaussian_logp(torch.tensor(x), torch.tensor(mu), torch.tensor(ls)).numpy(),
        np.asarray(jax_logp(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(ls))), atol=1e-5)


def test_running_stats():
    rng = np.random.RandomState(2)
    jr, tr = jrs.RunningMeanStd.create((OBS,)), trs.RunningMeanStd.create((OBS,), "cpu")
    for k in range(3):
        batch = (rng.normal(size=(2, 64, OBS)) * (k + 1) + k).astype(np.float32)
        jr = jrs.rms_update(jr, jnp.asarray(batch))
        tr = trs.rms_update(tr, torch.tensor(batch))
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)), rtol=1e-5, atol=1e-5)
    x = rng.normal(size=(8, OBS)).astype(np.float32) * 10
    np.testing.assert_allclose(trs.rms_normalize(tr, torch.tensor(x)).numpy(),
                               np.asarray(jrs.rms_normalize(jr, jnp.asarray(x))), atol=1e-4)
    np.testing.assert_allclose(trs.rms_denormalize(tr, torch.tensor(x)).numpy(),
                               np.asarray(jrs.rms_denormalize(jr, jnp.asarray(x))), rtol=1e-5, atol=1e-4)


def test_rollout_matches_jax_math(flax_policy):
    """Four rollout steps with the same action noise: the port's
    PPO.rollout against the JAX rollout step (learn/ppo.py:298-380)
    written out with the JAX env, network and running stats."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    net, params, port = flax_policy
    cfg = {"env": {"numEnvs": N, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Ant"]({"env": dict(cfg["env"]), "sim": {**cfg["sim"], "use_fused": True}})
        tenv = ttasks["Ant"]({k: dict(v) for k, v in cfg.items()}, device="cpu")
    gamma, horizon = 0.99, 4
    train = {"network": {"mlp": {"units": [256, 128, 64], "activation": "elu"}},
             "config": {"gamma": gamma, "horizon_length": horizon, "value_bootstrap": True}}
    agent = PPO(tenv, train, seed=0)
    agent.network.load_state_dict(port.state_dict())
    noise = np.random.RandomState(5).normal(size=(horizon, N, ACT)).astype(np.float32)

    # JAX side
    jstate, jobs = jenv.reset(jax.random.PRNGKey(0))
    obs_rms, value_rms = jrs.RunningMeanStd.create((OBS,)), jrs.RunningMeanStd.create(())
    ref = []
    for t in range(horizon):
        obs_rms = jrs.rms_update(obs_rms, jobs)
        mu, ls, v = net.apply(params, jrs.rms_normalize(obs_rms, jobs))
        value = jrs.rms_denormalize(value_rms, v)
        action = mu + jnp.exp(ls) * noise[t]
        logp = jax_logp(action, mu, ls)
        jstate, nobs, rew, done, ex = jenv.step(jstate, action)
        shaped = rew + gamma * value * ex["time_outs"]
        ref.append((jobs, action, logp, value, shaped, done))
        jobs = nobs
    _, _, v_last = net.apply(params, jrs.rms_normalize(obs_rms, jobs))
    last_ref = jrs.rms_denormalize(value_rms, v_last)

    # port side, from the same env state
    ts = agent.init()
    t_ = lambda a: torch.tensor(np.asarray(a))
    j0, o0 = jenv.reset(jax.random.PRNGKey(0))
    ts.env_state.sim = SimState(q=t_(j0.sim.q), qd=t_(j0.sim.qd))
    ts.env_state.task = tuple(t_(x) for x in j0.task)
    ts.obs = t_(o0)
    ts, traj, last = agent.rollout(ts, noise=torch.tensor(noise))
    for t, (o, a, lp, v, r, d) in enumerate(ref):
        np.testing.assert_allclose(traj.obs[t].numpy(), np.asarray(o), atol=1e-3)
        np.testing.assert_allclose(traj.action[t].numpy(), np.asarray(a), atol=1e-3)
        np.testing.assert_allclose(traj.logp[t].numpy(), np.asarray(lp), atol=1e-3)
        np.testing.assert_allclose(traj.value[t].numpy(), np.asarray(v), atol=1e-3)
        np.testing.assert_allclose(traj.reward[t].numpy(), np.asarray(r), atol=1e-3)
        np.testing.assert_array_equal(traj.done[t].numpy(), np.asarray(d))
    np.testing.assert_allclose(last.numpy(), np.asarray(last_ref), atol=1e-3)
    assert traj.obs.shape == (horizon, N, OBS) and traj.n_done.shape == (horizon,)
    assert int(ts.ep_len[0]) == horizon


@pytest.mark.parametrize("kwargs", [
    {"act": "relu"}, {"act": "tanh"}, {"act": "selu"}, {"act": "swish"}, {"act": "gelu"},
    {"act": "sigmoid"}, {"d2rl": True}, {"separate": True}, {"learn_sigma": False},
    {"act": "gelu", "d2rl": True, "separate": True},
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_network_options_match_flax(kwargs):
    """Every activation of the table, the d2rl skip-concatenation, the
    separate critic trunk and the fixed sigma: flax weights carried across,
    outputs within 1e-5 (float32 sums in another order)."""
    kw = {"sigma_init": -0.3, **kwargs}
    net = jnet.ActorCritic(num_actions=ACT, units=(32, 24, 16), **kw)
    params = net.init(jax.random.PRNGKey(4), jnp.zeros((1, OBS)))
    port = tnet.ActorCritic(OBS, ACT, units=(32, 24, 16), **kw)
    sd = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    obs = np.random.RandomState(6).normal(size=(16, OBS)).astype(np.float32) * 2.0
    mu, ls, v = net.apply(params, jnp.asarray(obs))
    tmu, tls, tv = (x.detach() for x in port(torch.tensor(obs)))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=1e-5)
    np.testing.assert_allclose(tls.numpy(), np.asarray(ls), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), atol=1e-5)
    names = {n for n, _ in port.named_parameters()}
    assert ("log_sigma" in names) == kw.get("learn_sigma", True)
    assert any(n.startswith("critic_mlp.") for n in names) == kw.get("separate", False)
    if kw.get("d2rl"):
        assert port.actor_mlp.fc1.in_features == 32 + OBS
