"""The port's PPO update against the JAX package: GAE, the loss and its
gradient, the KL, the learning-rate schedule, the Adam step, and whole
epochs on Cartpole and Ant.

Inputs come from numpy seeds and go through both packages in one process.
The JAX `train_epoch` draws its own action noise and permutations, so the
JAX side of the epoch is assembled here from the JAX package's own env,
network, running stats, `_gae`, `_loss`, `tx` and `_update_lr`, in the
order of isaacgymenvs_tpu/learn/ppo.py:501-634, and both sides get the same
`noise` and `perms`. The JAX env steps op by op (not under jit), as in
tests/test_torch_env.py.
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
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

ATOL, GRAD_RTOL = 1e-5, 1e-4  # float32 sums taken in another order
TASKS = {
    # task: (num_envs, env cfg, sim cfg, train config, scale of the action noise)
    "Cartpole": (8, {"clipObservations": 5.0, "clipActions": 1.0}, {"dt": 0.0166, "substeps": 2},
                 {"truncate_grads": True, "critic_coef": 4, "reward_shaper": {"scale_value": 0.1}}, 1.0),
    "Ant": (4, {"clipActions": 1.0}, {"dt": 1 / 60, "substeps": 2},
            {"truncate_grads": False, "critic_coef": 2, "value_bootstrap": True,
             "reward_shaper": {"scale_value": 0.01}}, 1.0),
    # pair row, anchors and q_target drives in the step; fixed sigma as in BallBalancePPO.yaml
    "BallBalance": (4, {"clipObservations": 5.0, "clipActions": 1.0, "actionSpeedScale": 20},
                    {"dt": 0.01, "substeps": 1, "physx": {"num_position_iterations": 8, "contact_offset": 0.02,
                                                          "max_depenetration_velocity": 1000.0}},
                    {"truncate_grads": True, "critic_coef": 4, "reward_shaper": {"scale_value": 0.1}}, 0.3),
}
HORIZON, MINI_EPOCHS, NUM_MB = 4, 2, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside `agent.tx`'s state (alone, or after
    the clip's empty state)."""
    return opt_state if hasattr(opt_state, "mu") else next(s for s in opt_state if hasattr(s, "mu"))


def _agents(task, **config):
    """A JAX agent and a port agent on the same task and train config."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    n, env_cfg, sim_cfg, train_cfg, _ = TASKS[task]
    env_cfg = {"numEnvs": n, **env_cfg}
    train = {"network": {"mlp": {"units": [32, 16], "activation": "elu"}},
             "config": {"horizon_length": HORIZON, "mini_epochs": MINI_EPOCHS,
                        "minibatch_size": HORIZON * n // NUM_MB, **train_cfg, **config}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks[task]({"env": dict(env_cfg), "sim": {**sim_cfg, "use_fused": True}})
        tenv = ttasks[task]({"env": dict(env_cfg), "sim": dict(sim_cfg)}, device="cpu")
    return jppo.PPO(jenv, train, seed=0), tppo.PPO(tenv, train, seed=0)


def _port_state_from(tagent, jts):
    """A port train state (and network) holding the JAX train state."""
    adam = _adam_state(jts.opt_state)
    fields = _np_tree({"params": jts.params, "obs_rms": vars(jts.obs_rms), "value_rms": vars(jts.value_rms),
                       "lr": jts.lr, "mu": adam.mu, "nu": adam.nu, "count": adam.count})
    names = [n for n, _ in tagent.network.named_parameters()]
    ts = tagent.load_state(tagent.init(), train_state_from_jax(fields, names))
    t = lambda a: torch.tensor(np.asarray(a))
    ts.env_state.sim = SimState(q=t(jts.env_state.sim.q), qd=t(jts.env_state.sim.qd))
    jtask = jts.env_state.task
    ts.env_state.task = tuple(t(x) for x in jtask) if isinstance(jtask, tuple) else t(jtask)
    ts.obs = t(jts.obs)
    return ts


def _port_params(tagent):
    return {k: v.detach().numpy() for k, v in tagent.network.state_dict().items()}


def _jax_params(params):
    return {k: v.numpy() for k, v in actor_critic_from_flax(_np_tree(params)).items()}


def _batch(rng, agent, n):
    """A random minibatch in the JAX layout (nobs, nstates, action, old_mu,
    old_log_sigma, old_logp, old_vnorm, adv, ret_norm)."""
    obs, act = agent.env.num_obs, agent.env.num_acts
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(n, obs), np.zeros((n, 1), np.float32), f(n, act), 0.3 * f(n, act), 0.2 * f(n, act),
            f(n) - 8.0, f(n), f(n), f(n))


def _port_batch(batch):
    return tuple(torch.tensor(x) for i, x in enumerate(batch) if i != 1)  # no privileged states


# ---- the pieces ---------------------------------------------------------------


def test_gae_matches_jax():
    jagent, tagent = _agents("Cartpole")
    rng = np.random.RandomState(0)
    T, N = 6, 5
    reward, value = (rng.normal(size=(T, N)).astype(np.float32) for _ in range(2))
    done = rng.uniform(size=(T, N)) < 0.3
    last = rng.normal(size=N).astype(np.float32)
    z = jnp.zeros(())
    jtraj = jppo.Transition(obs=z, action=z, states=z, extras={}, mu=z, sigma=z, logp=z,
                            value=jnp.asarray(value), reward=jnp.asarray(reward), done=jnp.asarray(done),
                            ep_ret_done=z, ep_len_done=z, n_done=z)
    jadv, jret = jagent._gae(jtraj, jnp.asarray(last))
    e = torch.zeros(())
    ttraj = tppo.Transition(obs=e, action=e, mu=e, sigma=e, logp=e, value=torch.tensor(value),
                            reward=torch.tensor(reward), done=torch.tensor(done),
                            ep_ret_done=e, ep_len_done=e, n_done=e, extras={})
    tadv, tret = tagent._gae(ttraj, torch.tensor(last))
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=ATOL)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=ATOL)


def test_policy_kl_matches_jax():
    rng = np.random.RandomState(1)
    a = [rng.normal(size=(16, 8)).astype(np.float32) * s for s in (1.0, 0.3, 1.0, 0.3)]
    got = tppo._policy_kl(*(torch.tensor(x) for x in a))
    np.testing.assert_allclose(got.numpy(), np.asarray(jppo._policy_kl(*(jnp.asarray(x) for x in a))), atol=ATOL)
    assert float(tppo._policy_kl(*(torch.tensor(x) for x in (a[0], a[1], a[0], a[1])))) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("clip_value", [True, False])
def test_loss_and_gradient_match_jax(clip_value):
    """The loss, its five parts and its gradient per parameter: atol 1e-5,
    gradients rtol 1e-4 besides."""
    jagent, tagent = _agents("Ant", clip_value=clip_value, entropy_coef=0.01)
    jts = jagent.init()
    tagent.network.load_state_dict(actor_critic_from_flax(_np_tree(jts.params)))
    batch = _batch(np.random.RandomState(2), jagent, 64)
    (jtotal, jaux), jgrads = jax.value_and_grad(jagent._loss, has_aux=True)(
        jts.params, tuple(jnp.asarray(x) for x in batch), jts.value_rms)
    ttotal, taux = tagent._loss(_port_batch(batch))
    ttotal.backward()
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal), atol=ATOL)
    for name, t, j in zip(("a_loss", "c_loss", "entropy", "b_loss", "kl"), taux, jaux):
        np.testing.assert_allclose(float(t.detach()), float(j), atol=ATOL, rtol=GRAD_RTOL, err_msg=name)
    jg = _jax_params(jgrads)
    params = dict(tagent.network.named_parameters())
    assert set(jg) == set(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), jg[name], atol=ATOL, rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("lr, kl", [
    (3e-4, 0.1),      # kl above twice the threshold: lr / 1.5
    (3e-4, 0.001),    # kl below half the threshold: lr * 1.5
    (3e-4, 0.008),    # in between: unchanged
    (9e-3, 0.0),      # clipped at max_lr
    (1.2e-6, 1.0),    # clipped at min_lr
])
def test_update_lr_matches_jax(lr, kl):
    jagent, tagent = _agents("Cartpole")
    want = float(jagent._update_lr(jnp.float32(lr), jnp.float32(kl)))
    assert tagent._update_lr(lr, kl) == pytest.approx(want, rel=1e-6)


def test_update_lr_linear_schedule_leaves_lr():
    jagent, tagent = _agents("Cartpole", lr_schedule="linear")
    assert tagent._update_lr(3e-4, 1.0) == 3e-4 == pytest.approx(float(jagent._update_lr(jnp.float32(3e-4), 1.0)))


@pytest.mark.parametrize("truncate_grads", [True, False])
def test_adam_step_matches_optax(truncate_grads):
    """Two optimizer steps on the same batches against `agent.tx` followed
    by -lr * u; with the clip the gradient norm is well above grad_norm."""
    jagent, tagent = _agents("Ant", truncate_grads=truncate_grads, grad_norm=0.05)
    jts = jagent.init()
    tts = _port_state_from(tagent, jts)
    rng = np.random.RandomState(4)
    params, opt_state = jts.params, jts.opt_state
    for lr in (3e-3, 1e-3):
        batch = _batch(rng, jagent, 32)
        grads, _ = jax.grad(jagent._loss, has_aux=True)(params, tuple(jnp.asarray(x) for x in batch), jts.value_rms)
        assert float(optax.global_norm(grads)) > 0.05
        updates, opt_state = jagent.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -lr * u, updates))
        tts.lr = lr
        tagent._minibatch_step(tts, _port_batch(batch), tts.value_rms)
        want, got = _jax_params(params), _port_params(tagent)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=ATOL, err_msg=name)
    adam = _adam_state(opt_state)
    mu = _jax_params(adam.mu)
    for i, (name, _) in enumerate(tagent.network.named_parameters()):
        st = tts.optimizer.state_dict()["state"][i]
        assert float(st["step"]) == float(adam.count) == 2.0
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name], atol=ATOL, err_msg=name)


# ---- the rollout's options ---------------------------------------------------


def _fix_reset_state(jagent, tagent):
    """An untrained Cartpole episode lasts a few steps, so envs finish and
    reset inside a rollout; each package draws reset states from its own
    generator, so both are given the same fixed reset state."""
    q0, qd0 = np.array([0.05, -0.03], np.float32), np.array([0.1, -0.2], np.float32)
    jagent.env.sample_init = lambda rng: (jnp.asarray(q0), jnp.asarray(qd0), ())
    tagent.env.sample_init = lambda gen, n: (torch.tensor(q0).repeat(n, 1), torch.tensor(qd0).repeat(n, 1), ())


@pytest.mark.parametrize("flag", ["normalize_input", "normalize_value"])
def test_rollout_without_normalization_matches_jax(flag):
    """The JAX package's own `rollout` against the port's with the flag off,
    fed the noise the JAX rollout draws from its key; atol 1e-4."""
    jagent, tagent = _agents("Cartpole", **{flag: False})
    jts = jagent.init()
    # normalizers that are not the identity, so that skipping one shows
    jts = jts.replace(value_rms=jts.value_rms.replace(mean=jnp.float32(0.5), var=jnp.float32(4.0)),
                      obs_rms=jts.obs_rms.replace(mean=jnp.full((4,), 0.1), var=jnp.full((4,), 0.25)))
    tts = _port_state_from(tagent, jts)
    _fix_reset_state(jagent, tagent)
    key, noise = jts.key, []
    for _ in range(HORIZON):
        key, ksample = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(ksample, (TASKS["Cartpole"][0], 1))))
    jts2, jtraj, jlast = jagent.rollout(jts)
    tts2, ttraj, tlast = tagent.rollout(tts, noise=torch.tensor(np.stack(noise)))
    for f in ("obs", "action", "mu", "logp", "value", "reward"):
        np.testing.assert_allclose(getattr(ttraj, f).numpy(), np.asarray(getattr(jtraj, f)), atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(ttraj.done.numpy(), np.asarray(jtraj.done))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4)
    np.testing.assert_allclose(tts2.obs_rms.mean.numpy(), np.asarray(jts2.obs_rms.mean), atol=1e-5)
    if flag == "normalize_input":  # the obs normalizer is left as it was
        assert torch.equal(tts2.obs_rms.mean, tts.obs_rms.mean)
    assert int(ttraj.n_done.sum()) == int(jtraj.n_done.sum())


@pytest.mark.parametrize("what, env_attrs, train, match", [
    ("recurrent network", {}, {"network": {"rnn": {"name": "lstm", "units": 32}}}, "rnn"),
])
def test_ppo_raises_for_what_is_not_ported(what, env_attrs, train, match):
    """Options whose code the port lacks raise by name instead of being
    ignored: a recurrent network is PPORecurrent's, not PPO's."""
    import types

    env = types.SimpleNamespace(num_obs=4, num_acts=1, num_envs=8, device=torch.device("cpu"), **env_attrs)
    with pytest.raises(NotImplementedError, match=match):
        tppo.PPO(env, train)


def test_rollout_captures_extras():
    """A subclass's `capture_extras` are kept per step in the rollout, time
    leading, equal to what each env step emitted; the other extras are not."""
    cfg = {"env": {"numEnvs": 8, "clipObservations": 5.0, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    env = ttasks["Cartpole"](cfg, device="cpu")
    step = env.step
    seen = []

    def with_obs_copy(state, actions):
        out = step(state, actions)
        seen.append(out[1] * 2.0)
        return (*out[:4], {**out[4], "doubled": seen[-1]})

    env.step = with_obs_copy
    agent = type("Capturing", (tppo.PPO,), {"capture_extras": ("doubled",)})(
        env, {"config": {"horizon_length": 3, "minibatch_size": 24, "mini_epochs": 1}}, seed=0)
    _, traj, _ = agent.rollout(agent.init())
    assert traj.extras["doubled"].shape == (3, 8, 4) and "time_outs" not in traj.extras
    torch.testing.assert_close(traj.extras["doubled"], torch.stack(seen))


def test_rollout_raises_for_episode_cumulative_extras():
    """`episode_cumulative` terms are summed per env from the first step
    that emits them (tests/test_torch_ppo_extras.py); an env whose terms
    change name between steps is refused, as the JAX package's compiled
    rollout fixes them from the first step's structure."""
    _, tagent = _agents("Cartpole")
    step, calls = tagent.env.step, []

    def step_with_cumulative(state, action):
        out = step(state, action)
        calls.append(1)
        return (*out[:4], {**out[4], "episode_cumulative": {"r" if len(calls) < 3 else "r2": out[2]}})

    tagent.env.step = step_with_cumulative
    with pytest.raises(ValueError, match="episode_cumulative"):
        tagent.rollout(tagent.init())
    assert len(calls) == 3


# ---- whole epochs ---------------------------------------------------------------


_JITTED = {}


def _jax_epoch(agent, ts, noise, perms, jit=False):
    """One epoch of the JAX package with given noise and permutations. With
    `jit` its env step and gradient run under `jax.jit`, compiled once per
    agent; without, op by op (Ant's potentials near 6e4 need the op-by-op
    rounding)."""
    step, grad = agent.env.step, jax.grad(agent._loss, has_aux=True)
    if jit:
        if id(agent) not in _JITTED:
            _JITTED[id(agent)] = (agent, jax.jit(step), jax.jit(grad))
        _, step, grad = _JITTED[id(agent)]
    cfg = agent.cfg
    pol = ts.params["policy"]
    env_state, obs, obs_rms = ts.env_state, ts.obs, ts.obs_rms
    rows = []
    for t in range(cfg.horizon_length):
        obs_rms = jrs.rms_update(obs_rms, obs)
        mu, ls, v = agent.network.apply(pol, jrs.rms_normalize(obs_rms, obs))
        value = jrs.rms_denormalize(ts.value_rms, v)
        action = mu + jnp.exp(ls) * noise[t]
        logp = jppo._gaussian_logp(action, mu, ls)
        env_state, next_obs, reward, done, extras = step(env_state, action)
        shaped = reward * cfg.reward_scale
        if cfg.value_bootstrap:
            shaped = shaped + cfg.gamma * value * extras["time_outs"]
        rows.append((obs, action, mu, ls, logp, value, shaped, done))
        obs = next_obs
    o, a, m, s, lp, val, rew, dn = (jnp.stack(x) for x in zip(*rows))
    z = jnp.zeros(())
    traj = jppo.Transition(obs=o, action=a, states=z, extras={}, mu=m, sigma=s, logp=lp, value=val,
                           reward=rew, done=dn, ep_ret_done=z, ep_len_done=z, n_done=jnp.sum(dn))
    _, _, v = agent.network.apply(pol, jrs.rms_normalize(obs_rms, obs))
    advantages, returns = agent._gae(traj, jrs.rms_denormalize(ts.value_rms, v))
    value_rms = jrs.rms_update(jrs.rms_update(ts.value_rms, traj.value), returns)
    old_vnorm = jrs.rms_normalize(value_rms, traj.value, clip=np.inf)
    ret_norm = jrs.rms_normalize(value_rms, returns, clip=np.inf)
    B = agent.batch_size
    flat = lambda x: x.reshape((B,) + x.shape[2:])
    adv = flat(advantages)
    adv = (adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-8)
    dataset = (flat(jrs.rms_normalize(obs_rms, traj.obs)), jnp.zeros((B, 1)), flat(a), flat(m), flat(s),
               flat(lp), flat(old_vnorm), adv, flat(ret_norm))
    params, opt_state, lr = ts.params, ts.opt_state, ts.lr
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
    metrics.update(kl=auxs[-agent.num_minibatches:, 4].mean(), lr=float(lr),
                   n_episodes=float(jnp.sum(dn)), reward_mean_step=float(jnp.mean(rew)))
    ts = ts.replace(params=params, opt_state=opt_state, lr=lr, obs_rms=obs_rms, value_rms=value_rms,
                    env_state=env_state, obs=obs)
    return ts, metrics


def _balls_on_trays(jagent, jts):
    """BallBalance's reset drops the ball from 1-2 m; put it on the tray in
    envs 0 and 1 so that the pair row acts inside the epochs."""
    env = jagent.env
    q, qd = np.asarray(jts.env_state.sim.q).copy(), np.asarray(jts.env_state.sim.qd).copy()
    bq, bv = env.ball_q, env.model.v_adr[env.ball_body]
    for e, xy in ((0, (0.05, -0.1)), (1, (-0.15, 0.1))):
        q[e, bq:bq + 3] = (*xy, env.tray_height + 0.01 + env.ball_radius - 0.002)
        qd[e, bv:bv + 3] = 0.0
    es = jts.env_state
    return jts.replace(env_state=es.replace(sim=es.sim.replace(q=jnp.asarray(q), qd=jnp.asarray(qd))))


@pytest.mark.parametrize("task", ["Cartpole", "Ant", "BallBalance"])
def test_two_epochs_match_jax(task):
    """A first epoch from a fresh state and a second one after it (non-zero
    Adam moments, moved normalizers and lr): metrics to rtol 2e-4 / atol
    2e-6, parameters after each epoch to atol 1e-4. The JAX epoch runs its
    env step and gradient under `jax.jit`, Ant's op by op."""
    jagent, tagent = _agents(task)
    n, scale = TASKS[task][0], TASKS[task][4]
    jts = jagent.init()
    if task == "BallBalance":
        jts = _balls_on_trays(jagent, jts)
    tts = _port_state_from(tagent, jts)
    if task == "Cartpole":
        _fix_reset_state(jagent, tagent)
    rng = np.random.RandomState(7)
    B = HORIZON * n
    finished = 0
    for epoch in range(2):
        noise = (scale * rng.normal(size=(HORIZON, n, jagent.env.num_acts))).astype(np.float32)
        perms = np.stack([rng.permutation(B) for _ in range(MINI_EPOCHS)])
        jts, want = _jax_epoch(jagent, jts, jnp.asarray(noise), perms, jit=task != "Ant")
        tts, got = tagent.train_epoch(tts, noise=torch.tensor(noise), perms=torch.tensor(perms))
        assert want["n_episodes"] == got["n_episodes"]
        finished += got["n_episodes"]
        for k in ("a_loss", "c_loss", "entropy", "b_loss", "kl", "lr", "reward_mean_step"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6, err_msg=f"epoch {epoch} {k}")
        jp, tp = _jax_params(jts.params), _port_params(tagent)
        for name in jp:
            np.testing.assert_allclose(tp[name], jp[name], atol=1e-4, err_msg=f"epoch {epoch} {name}")
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(tts.value_rms, f).numpy(), np.asarray(getattr(jts.value_rms, f)),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(getattr(tts.obs_rms, f).numpy(), np.asarray(getattr(jts.obs_rms, f)),
                                       rtol=1e-4, atol=1e-4)
    # Cartpole's epochs run through dones and resets; the Ant stays up (a
    # reset there would draw from each package's own generator)
    assert finished > 0 if task == "Cartpole" else finished == 0
    assert got["lr"] != tagent.cfg.learning_rate  # the schedule moved the lr
    assert set(got) >= {"a_loss", "c_loss", "entropy", "b_loss", "kl", "lr", "ep_return_sum", "ep_len_sum",
                        "n_episodes", "reward_mean_step"}


def test_train_epoch_draws_its_own_noise_and_shuffles():
    """Without `noise` and `perms` the epoch draws both from the state's
    generator: the same seed gives the same epoch, another seed another."""
    def run(seed):
        _, tagent = _agents("Cartpole")
        tagent.seed = seed
        ts, metrics = tagent.train_epoch(tagent.init())
        return metrics, _port_params(tagent)

    (m0, p0), (m1, p1), (m2, p2) = run(0), run(0), run(5)
    assert m0 == m1 and all(np.array_equal(p0[k], p1[k]) for k in p0)
    assert any(not np.array_equal(p0[k], p2[k]) for k in p0)
    assert all(np.isfinite(v) for v in m0.values())
