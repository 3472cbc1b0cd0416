"""The port's LSTM actor-critic and recurrent PPO against the JAX package.

Weights go across with `convert.actor_critic_from_flax` (the flax
`OptimizedLSTMCell` kernels side by side in the port's cell). The epoch
parity assembles the JAX side from the JAX package's own network, `_gae`,
`_seq_loss`, `tx` and `_update_lr` in the order of
isaacgymenvs_tpu/learn/rnn.py:137-360 (the env step and the gradient
jitted), and hands both sides the same action noise and window
permutations, on Cartpole at the sizes of tests/test_rnn.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isaacgymenvs_tpu.learn import ppo as jppo
from isaacgymenvs_tpu.learn import rnn as jrnn
from isaacgymenvs_tpu.learn import running_stats as jrs
from isaacgymenvs_tpu_torch.convert import actor_critic_from_flax, train_state_from_jax
from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.learn import rnn as trnn
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 16
CFG = {"env": {"numEnvs": N, "clipActions": 1.0, "episodeLength": 50}, "sim": {"dt": 1 / 60, "substeps": 2}}
TRAIN = {"network": {"mlp": {"units": [16]}, "rnn": {"units": 32, "before_mlp": False}},
         "config": {"horizon_length": 8, "minibatch_size": 32, "mini_epochs": 2, "seq_length": 4,
                    "reward_shaper": {"scale_value": 0.1}}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _agents(train=TRAIN, n=N):
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    env = {**CFG["env"], "numEnvs": n}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Cartpole"]({"env": dict(env), "sim": {**CFG["sim"], "use_fused": True}})
        tenv = ttasks["Cartpole"]({"env": dict(env), "sim": dict(CFG["sim"])}, device="cpu")
    # every reset lands in one state in both packages
    q0, qd0 = np.array([0.05, -0.03], np.float32), np.array([0.1, -0.2], np.float32)
    jenv.sample_init = lambda rng: (jnp.asarray(q0), jnp.asarray(qd0), ())
    tenv.sample_init = lambda gen, k: (torch.tensor(q0).repeat(k, 1), torch.tensor(qd0).repeat(k, 1), ())
    return jrnn.PPORecurrent(jenv, train, seed=0), trnn.PPORecurrent(tenv, train, seed=0)


def _jitter(params, seed):
    """flax's zero biases made random, so that a misplaced bias shows."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(tree, [x + 0.2 * rng.normal(size=x.shape).astype(np.float32) for x in leaves])


@pytest.mark.parametrize("before_mlp, layer_norm", [(True, True), (False, False)])
def test_lstm_step_and_sequence_match_flax(before_mlp, layer_norm):
    """One step and an 8-step sequence (the carry threaded) of
    LSTMActorCritic against the flax module with the same weights: carry,
    mu, log-sigma and value within 1e-5."""
    jnet = jrnn.LSTMActorCritic(num_actions=3, units=(16, 8), rnn_units=12, before_mlp=before_mlp,
                                layer_norm=layer_norm, sigma_init=-0.5)
    rng = np.random.RandomState(0)
    obs = rng.normal(size=(8, 5, 7)).astype(np.float32)
    params = _jitter(jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs[0]), jnet.initial_carry((5,))), 1)
    tnet = trnn.LSTMActorCritic(7, 3, units=(16, 8), rnn_units=12, before_mlp=before_mlp, layer_norm=layer_norm,
                                sigma_init=-0.5)
    tnet.load_state_dict(actor_critic_from_flax(_np_tree(params)))
    c0 = tuple(rng.normal(size=(5, 12)).astype(np.float32) for _ in range(2))
    jc, tc = tuple(jnp.asarray(x) for x in c0), tuple(torch.tensor(x) for x in c0)
    with torch.no_grad():
        for t in range(8):
            jc, jout = jnet.apply(params, jnp.asarray(obs[t]), jc)
            tc, tout = tnet(torch.tensor(obs[t]), tc)
            for name, a, b in zip(("c", "h", "mu", "log_sigma", "value"), (*tc, *tout), (*jc, *jout)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=f"step {t} {name}")


def _port_state_from(tagent, jts):
    adam = next(s for s in jts.opt_state if hasattr(s, "mu"))
    fields = _np_tree({"params": jts.params, "obs_rms": vars(jts.obs_rms), "value_rms": vars(jts.value_rms),
                       "lr": jts.lr, "mu": adam.mu, "nu": adam.nu, "count": adam.count})
    ts = tagent.load_state(tagent.init(), train_state_from_jax(fields, [n for n, _ in tagent.named_trainables()]))
    t = lambda a: torch.tensor(np.asarray(a))
    ts.env_state.sim = SimState(q=t(jts.env_state.sim.q), qd=t(jts.env_state.sim.qd))
    ts.obs = t(jts.obs)
    ts.carry = tuple(t(x) for x in jts.states)
    return ts


_JITTED = {}


def _jitted(fn):
    """One jitted copy of `fn` per process (Cartpole's step has no float
    rounding that jit would move beyond the tolerances)."""
    return _JITTED.setdefault(fn, jax.jit(fn))


def _jax_epoch(agent, ts, noise, perms):
    """One PPORecurrent epoch of the JAX package with given noise and window
    permutations."""
    cfg, pol = agent.cfg, ts.params["policy"]
    env_state, obs, obs_rms, carry = ts.env_state, ts.obs, ts.obs_rms, ts.states
    rows, carries = [], []
    step = _jitted(agent.env.step)
    for t in range(cfg.horizon_length):
        obs_rms = jrs.rms_update(obs_rms, obs)
        new_carry, (mu, ls, v) = agent.network.apply(pol, jrs.rms_normalize(obs_rms, obs), carry)
        value = jrs.rms_denormalize(ts.value_rms, v)
        action = mu + jnp.exp(ls) * noise[t]
        env_state, next_obs, reward, done, _ = step(env_state, action)
        carries.append(carry)
        rows.append((obs, action, mu, ls, jppo._gaussian_logp(action, mu, ls), value, reward * cfg.reward_scale, done))
        carry = tuple(x * (1.0 - done.astype(jnp.float32))[:, None] for x in new_carry)
        obs = next_obs
    o, a, m, s, lp, val, rew, dn = (jnp.stack(x) for x in zip(*rows))
    z = jnp.zeros(())
    states = tuple(jnp.stack(x) for x in zip(*carries))
    traj = jppo.Transition(obs=o, action=a, states=states, extras={}, mu=m, sigma=s, logp=lp, value=val,
                           reward=rew, done=dn, ep_ret_done=z, ep_len_done=z, n_done=jnp.sum(dn))
    _, (_, _, v) = agent.network.apply(pol, jrs.rms_normalize(obs_rms, obs), carry)
    advantages, returns = agent._gae(traj, jrs.rms_denormalize(ts.value_rms, v))
    value_rms = jrs.rms_update(jrs.rms_update(ts.value_rms, traj.value), returns)
    old_vnorm = jrs.rms_normalize(value_rms, traj.value, clip=np.inf)
    ret_norm = jrs.rms_normalize(value_rms, returns, clip=np.inf)
    adv = advantages.reshape(-1)
    adv = ((adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-8)).reshape(advantages.shape)
    S, L, n = agent.seqs_per_env, agent.seq_length, agent.env.num_envs

    def to_seq(x):
        x = x.reshape((S, L, n) + x.shape[2:])
        return jnp.moveaxis(x, 2, 0).reshape((S * n, L) + x.shape[3:])

    def seq_starts(x):
        x = x.reshape((S, L, n) + x.shape[2:])[:, 0]
        return jnp.moveaxis(x, 1, 0).reshape((S * n,) + x.shape[2:])

    dataset = (to_seq(jrs.rms_normalize(obs_rms, o)), tuple(seq_starts(c) for c in states), to_seq(a),
               to_seq(m), to_seq(s), to_seq(lp), to_seq(old_vnorm), to_seq(adv), to_seq(ret_norm))
    params, opt_state, lr = ts.params, ts.opt_state, ts.lr
    sm, auxs = agent.seq_minibatch, []
    grad = _jitted(jax.grad(agent._seq_loss, has_aux=True))
    for e in range(cfg.mini_epochs):
        shuffled = jax.tree_util.tree_map(lambda x: x[perms[e]], dataset)
        for i in range(agent.num_seqs // sm):
            mb = jax.tree_util.tree_map(lambda x: x[i * sm:(i + 1) * sm], shuffled)
            grads, aux = grad(params, mb)
            updates, opt_state = agent.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -lr * u, updates))
            lr = agent._update_lr(lr, aux[4])
            auxs.append([float(x) for x in aux])
    auxs = np.asarray(auxs)
    metrics = dict(zip(("a_loss", "c_loss", "entropy", "b_loss"), auxs[:, :4].mean(0)))
    metrics.update(kl=auxs[-(agent.num_seqs // sm):, 4].mean(), lr=float(lr), n_episodes=float(jnp.sum(dn)),
                   reward_mean_step=float(jnp.mean(rew)))
    ts = ts.replace(params=params, opt_state=opt_state, lr=lr, obs_rms=obs_rms, value_rms=value_rms,
                    env_state=env_state, obs=obs, states=carry)
    return ts, metrics


def test_epoch_matches_jax():
    """Two whole PPORecurrent epochs on Cartpole (tests/test_rnn.py's sizes:
    16 envs, an LSTM of 32 after an MLP of 16, horizon 8 in windows of 4,
    minibatches of 32 transitions, 2 mini-epochs) with the same noise and
    permutations: metrics at rtol 2e-4, parameters and the carry at rtol
    2e-4 (atol 1e-5), episodes finishing inside the rollouts."""
    jagent, tagent = _agents()
    jts = jagent.init()
    tts = _port_state_from(tagent, jts)
    rng = np.random.RandomState(7)
    finished = 0
    for epoch in range(2):
        noise = rng.normal(size=(8, N, 1)).astype(np.float32)
        perms = np.stack([rng.permutation(tagent.num_seqs) for _ in range(2)])
        jts, want = _jax_epoch(jagent, jts, jnp.asarray(noise), perms)
        tts, got = tagent.train_epoch(tts, noise=torch.tensor(noise), perms=torch.tensor(perms))
        assert got["n_episodes"] == want["n_episodes"]
        finished += got["n_episodes"]
        for k in ("a_loss", "c_loss", "entropy", "b_loss", "kl", "lr", "reward_mean_step"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6, err_msg=f"epoch {epoch} {k}")
        jp = actor_critic_from_flax(_np_tree(jts.params))
        tp = tagent.network.state_dict()
        assert set(jp) == set(tp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), jp[k].numpy(), rtol=2e-4, atol=1e-5, err_msg=f"epoch {epoch} {k}")
        for a, b in zip(tts.carry, jts.states):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=1e-5)
    assert finished > 0


def test_rollout_stores_pre_step_carry_and_zeroes_done_envs():
    """The transitions hold each step's carry from before the step; after a
    step that ends an episode the env's carry is zero, elsewhere not."""
    _, tagent = _agents()
    ts = tagent.init()
    q = ts.env_state.sim.q.clone()
    q[:4, 1] = 1.7  # poles past their limit: these envs end on the first step
    ts.env_state.sim = SimState(q=q, qd=ts.env_state.sim.qd)
    ts.carry = tuple(torch.full((N, 32), 0.3) for _ in range(2))
    ts2, traj, _ = tagent.rollout(ts, noise=torch.zeros(8, N, 1))
    assert all(torch.equal(x[0], torch.full((N, 32), 0.3)) for x in traj.states)
    assert traj.done[0, :4].all() and not traj.done[0, 4:].any()
    for x in traj.states:  # the carry after step 0 is the one stored for step 1
        assert torch.equal(x[1, :4], torch.zeros(4, 32)) and bool((x[1, 4:] != 0).any(dim=1).all())
    assert traj.states[0].shape == (8, N, 32) and ts2.carry[1].shape == (N, 32)


def test_play_step_threads_and_resets_the_carry():
    """tests/test_rnn.py's recurrent-player case on the port, and against the
    JAX player with the same weights: history changes the action, a done
    env restarts from a zero carry, the carry advances in the state."""
    train = {**TRAIN, "config": {**TRAIN["config"], "minibatch_size": 16, "mini_epochs": 1}}
    jagent, tagent = _agents(train, n=4)
    jts = jagent.init()
    tts = _port_state_from(tagent, jts)
    obs, no_done, done = tts.obs, torch.zeros(4, dtype=torch.bool), torch.ones(4, dtype=torch.bool)
    a1, ts1 = tagent._play_step(tts, obs, no_done)
    a2, ts2 = tagent._play_step(ts1, obs, no_done)
    a3, _ = tagent._play_step(ts2, obs, done)
    assert float((a2 - a1).abs().max()) > 1e-7
    np.testing.assert_allclose(a3.numpy(), a1.numpy(), atol=1e-6)
    assert float(ts2.carry[1].abs().max()) > 0 and torch.equal(tts.carry[1], torch.zeros(4, 32))
    jobs, jno = jnp.asarray(obs.numpy()), jnp.zeros(4, bool)
    j1, jts1 = jagent._play_step(jts, jobs, jno)
    j2, _ = jagent._play_step(jts1, jobs, jno)
    for a, b in ((a1, j1), (a2, j2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert torch.equal(tagent.act(ts2, obs), tagent.act(ts2, obs))


def test_window_settings():
    """seq_len stands for seq_length; windows must tile the horizon and the
    minibatch; a feed-forward PPO refuses a network.rnn block."""
    from isaacgymenvs_tpu_torch.learn import PPO

    env = _agents()[1].env
    conf = lambda **c: {**TRAIN, "config": {**TRAIN["config"], **c}}
    cfg = conf(seq_len=2)
    del cfg["config"]["seq_length"]
    agent = trnn.PPORecurrent(env, cfg)
    assert (agent.seq_length, agent.num_seqs, agent.seq_minibatch) == (2, 64, 16)
    with pytest.raises(ValueError, match="seq_length"):
        trnn.PPORecurrent(env, conf(seq_length=3))
    with pytest.raises(ValueError, match="minibatch_size 64 is not a multiple of seq_length 12"):
        trnn.PPORecurrent(env, conf(horizon_length=12, minibatch_size=64, seq_length=12))
    with pytest.raises(NotImplementedError, match="PPORecurrent"):
        PPO(env, TRAIN)
