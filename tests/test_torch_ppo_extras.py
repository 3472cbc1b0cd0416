"""PPO's central value net and episode-cumulative extras in the port.

The central value: Ant given privileged states by a shim (the sim's q and
qd as `num_states`, `states_of` and extras['states'], the same in both
packages) trains one epoch against the JAX package, whose side is assembled
from its own network, central net, `_gae`, `_loss`, `tx` and `_update_lr`
in the order of isaacgymenvs_tpu/learn/ppo.py:295-634 with the JAX env
stepped op by op (the potentials near 6e4 round as the port's only then),
both sides given the same action noise and permutations.

The episode-cumulative extras: Cartpole behind the wrapper of
tests/test_ppo.py:116-169, whose term is the reward itself, so that the
mean cumulative term of the episodes finished in a rollout must equal their
mean return.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isaacgymenvs_tpu.learn import ppo as jppo
from isaacgymenvs_tpu.learn import running_stats as jrs
from isaacgymenvs_tpu_torch.convert import actor_critic_from_flax, train_state_from_jax
from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.learn import ppo as tppo
from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N, HORIZON = 4, 2
ANT = {"env": {"numEnvs": N, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
CV_TRAIN = {"network": {"mlp": {"units": [32, 16], "activation": "elu"}},
            "config": {"horizon_length": HORIZON, "mini_epochs": 2, "minibatch_size": 4, "truncate_grads": True,
                       "grad_norm": 0.5, "critic_coef": 2, "value_bootstrap": True,
                       "reward_shaper": {"scale_value": 0.01},
                       "central_value_config": {"network": {"mlp": {"units": [24, 12], "activation": "elu"}}}}}


class _StatesShim:
    """Privileged states for an env that has none: the sim's (q, qd)."""

    def __init__(self, env, cat):
        self._env, self._cat = env, cat
        self.num_states = env.model.nq + env.model.nv

    def __getattr__(self, k):
        return getattr(self._env, k)

    def states_of(self, state):
        return self._cat(state.sim.q, state.sim.qd)

    def step(self, state, actions):
        state, obs, rew, done, extras = self._env.step(state, actions)
        return state, obs, rew, done, {**extras, "states": self._cat(state.sim.q, state.sim.qd)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cv_agents():
    from isaacgymenvs_tpu.tasks import task_map as jtasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Ant"]({"env": dict(ANT["env"]), "sim": {**ANT["sim"], "use_fused": True}})
        tenv = ttasks["Ant"]({k: dict(v) for k, v in ANT.items()}, device="cpu")
    jenv = _StatesShim(jenv, lambda q, qd: jnp.concatenate([q, qd], -1))
    tenv = _StatesShim(tenv, lambda q, qd: torch.cat([q, qd], -1))
    return jppo.PPO(jenv, CV_TRAIN, seed=0), tppo.PPO(tenv, CV_TRAIN, seed=0)


def _jax_init(agent):
    """`PPO.init` of the JAX package without its probe of the step's extras
    (an abstract trace of the whole env step, which this env does not need)."""
    key, knet, kcv, kenv = jax.random.split(jax.random.PRNGKey(agent.seed), 4)
    env_state, obs = agent.env.reset(kenv)
    states = agent.env.states_of(env_state)
    params = {"policy": agent.network.init(knet, obs[:1]), "central": agent.central_net.init(kcv, states[:1])}
    n = agent.env.num_envs
    return jppo.PPOTrainState(
        params=params, opt_state=agent.tx.init(params), lr=jnp.asarray(agent.cfg.learning_rate),
        obs_rms=jrs.RunningMeanStd.create((agent.env.num_obs,)), value_rms=jrs.RunningMeanStd.create(()),
        env_state=env_state, obs=obs, key=key, ep_return=jnp.zeros(n), ep_len=jnp.zeros(n, jnp.int32),
        states=states, state_rms=jrs.RunningMeanStd.create((agent.env.num_states,)))


def _port_state_from(tagent, jts):
    adam = next(s for s in jts.opt_state if hasattr(s, "mu"))
    fields = _np_tree({"params": jts.params, "obs_rms": vars(jts.obs_rms), "value_rms": vars(jts.value_rms),
                       "state_rms": vars(jts.state_rms), "lr": jts.lr, "mu": adam.mu, "nu": adam.nu,
                       "count": adam.count})
    ts = tagent.load_state(tagent.init(), train_state_from_jax(fields, [n for n, _ in tagent.named_trainables()]))
    t = lambda a: torch.tensor(np.asarray(a))
    ts.env_state.sim = SimState(q=t(jts.env_state.sim.q), qd=t(jts.env_state.sim.qd))
    ts.env_state.task = tuple(t(x) for x in jts.env_state.task)
    ts.obs, ts.states = t(jts.obs), t(jts.states)
    return ts


def _jax_cv_epoch(agent, ts, noise, perms):
    """One epoch of the JAX package with its central value net, given noise
    and permutations."""
    cfg, pol, cen = agent.cfg, ts.params["policy"], ts.params["central"]
    env_state, obs, states, obs_rms, state_rms = ts.env_state, ts.obs, ts.states, ts.obs_rms, ts.state_rms
    rows = []
    for t in range(cfg.horizon_length):
        obs_rms, state_rms = jrs.rms_update(obs_rms, obs), jrs.rms_update(state_rms, states)
        mu, ls, _ = agent.network.apply(pol, jrs.rms_normalize(obs_rms, obs))
        value = jrs.rms_denormalize(ts.value_rms, agent.central_net.apply(cen, jrs.rms_normalize(state_rms, states)))
        action = mu + jnp.exp(ls) * noise[t]
        env_state, next_obs, reward, done, extras = agent.env.step(env_state, action)
        shaped = reward * cfg.reward_scale + cfg.gamma * value * extras["time_outs"]
        rows.append((obs, states, action, mu, ls, jppo._gaussian_logp(action, mu, ls), value, shaped, done))
        obs, states = next_obs, extras["states"]
    o, st, a, m, s, lp, val, rew, dn = (jnp.stack(x) for x in zip(*rows))
    z = jnp.zeros(())
    traj = jppo.Transition(obs=o, action=a, states=st, extras={}, mu=m, sigma=s, logp=lp, value=val, reward=rew,
                           done=dn, ep_ret_done=z, ep_len_done=z, n_done=jnp.sum(dn))
    last = jrs.rms_denormalize(ts.value_rms, agent.central_net.apply(cen, jrs.rms_normalize(state_rms, states)))
    advantages, returns = agent._gae(traj, last)
    value_rms = jrs.rms_update(jrs.rms_update(ts.value_rms, traj.value), returns)
    old_vnorm = jrs.rms_normalize(value_rms, traj.value, clip=np.inf)
    ret_norm = jrs.rms_normalize(value_rms, returns, clip=np.inf)
    B = agent.batch_size
    flat = lambda x: x.reshape((B,) + x.shape[2:])
    adv = flat(advantages)
    adv = (adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-8)
    dataset = (flat(jrs.rms_normalize(obs_rms, o)), flat(jrs.rms_normalize(state_rms, st)), flat(a), flat(m),
               flat(s), flat(lp), flat(old_vnorm), adv, flat(ret_norm))
    params, opt_state, lr = ts.params, ts.opt_state, ts.lr
    grad = jax.jit(jax.grad(agent._loss, has_aux=True))
    auxs = []
    for e in range(cfg.mini_epochs):
        shuffled = [x[perms[e]] for x in dataset]
        for i in range(agent.num_minibatches):
            mb = tuple(x[i * agent.minibatch_size:(i + 1) * agent.minibatch_size] for x in shuffled)
            grads, aux = grad(params, mb, value_rms)
            updates, opt_state = agent.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -lr * u, updates))
            lr = agent._update_lr(lr, aux[4])
            auxs.append([float(x) for x in aux])
    auxs = np.asarray(auxs)
    metrics = dict(zip(("a_loss", "c_loss", "entropy", "b_loss"), auxs[:, :4].mean(0)))
    metrics.update(kl=auxs[-agent.num_minibatches:, 4].mean(), lr=float(lr), reward_mean_step=float(jnp.mean(rew)))
    return ts.replace(params=params, opt_state=opt_state, lr=lr, obs_rms=obs_rms, state_rms=state_rms,
                      value_rms=value_rms, env_state=env_state, obs=obs, states=states), metrics


def test_central_value_epoch_matches_jax():
    """An Ant epoch with the central value net (its own `central_value_config`
    widths) against the JAX package: metrics at rtol 2e-4, the policy's and
    the central net's parameters at rtol 2e-4 (atol 1e-5), the state
    normalizer at rtol 1e-4."""
    jagent, tagent = _cv_agents()
    assert tagent.use_central_value and tagent.central_net.cv_mlp.fc1.out_features == 12
    jts = _jax_init(jagent)
    tts = _port_state_from(tagent, jts)
    rng = np.random.RandomState(7)
    noise = rng.normal(size=(HORIZON, N, 8)).astype(np.float32)
    perms = np.stack([rng.permutation(HORIZON * N) for _ in range(2)])
    jts, want = _jax_cv_epoch(jagent, jts, jnp.asarray(noise), perms)
    tts, got = tagent.train_epoch(tts, noise=torch.tensor(noise), perms=torch.tensor(perms))
    for k in ("a_loss", "c_loss", "entropy", "b_loss", "kl", "lr", "reward_mean_step"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6, err_msg=k)
    jp = {**actor_critic_from_flax(_np_tree(jts.params["policy"])),
          **{f"central.{k}": v for k, v in actor_critic_from_flax(_np_tree(jts.params["central"])).items()}}
    tp = {n: p.detach() for n, p in tagent.named_trainables()}
    assert set(jp) == set(tp) and any(k.startswith("central.") for k in tp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), jp[k].numpy(), rtol=2e-4, atol=1e-5, err_msg=k)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tts.state_rms, f).numpy(), np.asarray(getattr(jts.state_rms, f)),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tts.states.numpy(), np.asarray(jts.states), atol=1e-4)


def test_central_value_checkpoint_roundtrip(tmp_path):
    """The checkpoint carries the central net and the state normalizer;
    restored into an agent of another seed they come back bit for bit, with
    the optimizer's moments of both nets."""
    _, tagent = _cv_agents()
    ts = tagent.init()
    ts, _ = tagent.train_epoch(ts)
    path = str(tmp_path / "cv.pth")
    tagent.save(path, ts, epoch=1)
    other = _cv_agents()[1]
    other.seed = 5
    ots, epoch = other.restore(path, other.init())
    assert epoch == 1
    for (n, a), (_, b) in zip(tagent.named_trainables(), other.named_trainables(), strict=True):
        assert torch.equal(a, b), n
    assert all(torch.equal(getattr(ts.state_rms, f), getattr(ots.state_rms, f)) for f in ("mean", "var", "count"))
    # Adam holds moments for every parameter with a gradient: the policy's
    # value head has none with a central value, as optax's stay zero for it
    sa, sb = ts.optimizer.state_dict()["state"], ots.optimizer.state_dict()["state"]
    names = [n for n, _ in tagent.named_trainables()]
    assert set(sa) == set(sb) == {i for i, n in enumerate(names) if not n.startswith("value.")}
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in ("exp_avg", "exp_avg_sq", "step"))


def test_vectask_privileged_states():
    """A task with num_states and observe_state emits extras['states'] each
    step, clipped as the observations, and `states_of` gives the same
    function of the current state with the sensors at zero."""
    class AntWithStates(ttasks["Ant"]):
        num_states = 29

        def observe_state(self, q, qd, kin, sensors, task, actions, progress):
            return torch.cat([q, qd], -1) * 10.0

    cfg = {"env": {**ANT["env"], "clipObservations": 5.0}, "sim": dict(ANT["sim"])}
    env = AntWithStates(cfg, device="cpu")
    st, _ = env.reset(0)
    torch.testing.assert_close(env.states_of(st), torch.clamp(torch.cat([st.sim.q, st.sim.qd], -1) * 10, -5, 5))
    st, _, _, _, extras = env.step(st, torch.zeros(N, 8))
    assert extras["states"].shape == (N, 29) and float(extras["states"].abs().max()) <= 5.0
    torch.testing.assert_close(extras["states"], env.states_of(st))


class _EpCumWrapper:
    """tests/test_ppo.py's wrapper: extras['episode_cumulative'] = {"r": reward}."""

    def __init__(self, env, terms=lambda rew, k: {"r": rew}):
        self._env, self._terms, self._k = env, terms, 0

    def __getattr__(self, k):
        return getattr(self._env, k)

    def step(self, state, actions):
        state, obs, rew, done, extras = self._env.step(state, actions)
        self._k += 1
        return state, obs, rew, done, {**extras, "episode_cumulative": self._terms(rew, self._k)}


def test_episode_cumulative_stats():
    """tests/test_ppo.py::test_episode_cumulative_stats on the port: the
    per-env sums run across rollouts, are captured where an episode ends
    and reset there; the mean cumulative 'r' of the episodes finished in a
    rollout equals that rollout's mean finished-episode return (rtol 1e-5),
    between its _min and _max."""
    cfg = {"env": {"numEnvs": 32, "clipObservations": 5.0, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    env = _EpCumWrapper(ttasks["Cartpole"](cfg, device="cpu"))
    agent = tppo.PPO(env, {"config": {"horizon_length": 64, "minibatch_size": 512, "mini_epochs": 1}}, seed=3)
    ts = agent.init()
    assert ts.ep_cum is None  # the sums start at the first step that emits terms
    for _ in range(6):
        ts, metrics = agent.train_epoch(ts)
    assert set(ts.ep_cum) == {"r"} and ts.ep_cum["r"].shape == (32,)
    n = metrics["n_episodes"]
    assert n > 0, "need finished episodes for the invariant"
    np.testing.assert_allclose(metrics["episode_cumulative/r"], metrics["ep_return_sum"] / n, rtol=1e-5)
    assert (metrics["episode_cumulative_min/r_min"] <= metrics["episode_cumulative/r"]
            <= metrics["episode_cumulative_max/r_max"])
    # the running sums equal the running returns of the unfinished episodes
    torch.testing.assert_close(ts.ep_cum["r"], ts.ep_return)


def test_episode_cumulative_without_finished_episodes_is_not_finite_and_not_logged(tmp_path):
    """A rollout in which no episode ends reports inf / -inf for _min / _max
    (as the JAX package does); the logger only takes them once episodes end."""
    cfg = {"env": {"numEnvs": 4, "clipObservations": 5.0, "clipActions": 1.0, "episodeLength": 500},
           "sim": {"dt": 1 / 60, "substeps": 2}}
    env = _EpCumWrapper(ttasks["Cartpole"](cfg, device="cpu"))
    agent = tppo.PPO(env, {"config": {"horizon_length": 2, "minibatch_size": 8, "mini_epochs": 1}}, seed=0)
    ts, metrics = agent.train_epoch(agent.init(), noise=torch.zeros(2, 4, 1))
    assert metrics["n_episodes"] == 0 and metrics["episode_cumulative/r"] == 0.0
    assert metrics["episode_cumulative_min/r_min"] == float("inf")
    assert metrics["episode_cumulative_max/r_max"] == -float("inf")
    logged = []
    logger = type("L", (), {"log": lambda self, d, f: logged.append(d)})()
    agent.train(max_epochs=1, logger=logger)
    assert "episode_cumulative/r" in logged[0] and "episode_cumulative_min/r_min" not in logged[0]
