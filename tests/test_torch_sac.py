"""The port's replay buffer and SAC against the JAX package, on Cartpole.

The JAX side draws its buffer indices and action noise from keys; here the
same keys are split as isaacgymenvs_tpu/learn/sac.py splits them, the draws
made with jax.random, and the port is handed them (`idx`, `noise`). The
weights go across with `convert.sac_state_from_jax`. Cartpole's reset
state is fixed in both packages, as each draws resets from its own
generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.learn import replay_buffer as jrb
from isaacgymenvs_tpu.learn import sac as jsac
from isaacgymenvs_tpu_torch.convert import sac_state_from_jax
from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.learn import sac as tsac
from isaacgymenvs_tpu_torch.learn.replay_buffer import ReplayBuffer
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N, A = 8, 1
CFG = {"env": {"numEnvs": N, "clipObservations": 5.0, "clipActions": 1.0}, "sim": {"dt": 0.0166, "substeps": 2}}
TRAIN = {"network": {"mlp": {"units": [32, 32], "activation": "relu"}, "log_std_bounds": [-5, 2]},
         "config": {"batch_size": 64, "num_steps_per_episode": 4, "num_warmup_steps": 2, "num_seed_steps": 1,
                    "replay_buffer_size": 512, "reward_shaper": {"scale_value": 0.1}}}
RTOL, ATOL = 2e-4, 1e-6


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
    return jsac.SAC(jenv, train, seed=0), tsac.SAC(tenv, train, seed=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_from(tagent, jts):
    """A port train state (and networks) holding the JAX train state."""
    fields = _np_tree({"actor_params": jts.actor_params, "critic_params": jts.critic_params,
                       "target_params": jts.target_params, "log_alpha": jts.log_alpha,
                       "obs_rms": vars(jts.obs_rms)})
    ts = tagent.load_state(tagent.init(), sac_state_from_jax(fields))
    t = lambda a: torch.tensor(np.asarray(a))
    for k, v in jts.buffer.data.items():
        ts.buffer.data[k] = t(v).clone()
    ts.buffer.idx, ts.buffer.size = int(jts.buffer.idx), int(jts.buffer.size)
    ts.env_state.sim = SimState(q=t(jts.env_state.sim.q), qd=t(jts.env_state.sim.qd))
    ts.env_state.progress = t(jts.env_state.progress).to(torch.int32)
    ts.env_state.reset_buf = t(jts.env_state.reset_buf)
    ts.obs = t(jts.obs)
    ts.total_steps = int(jts.total_steps)
    return ts


def _assert_params_match(tagent, jts, what=""):
    conv = sac_state_from_jax(_np_tree({"actor_params": jts.actor_params, "critic_params": jts.critic_params,
                                         "target_params": jts.target_params, "log_alpha": jts.log_alpha,
                                         "obs_rms": vars(jts.obs_rms)}))
    for name, module in (("actor_params", tagent.actor), ("critic_params", tagent.critic),
                         ("target_params", tagent.target)):
        got = module.state_dict()
        assert set(got) == set(conv[name])
        for k, v in conv[name].items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{what} {name} {k}")
    np.testing.assert_allclose(float(tagent.log_alpha.detach()), float(conv["log_alpha"]), rtol=RTOL, atol=ATOL)


def test_replay_buffer_ring_and_sample_match_jax():
    """Three batches (the second and third wrap) give the same contents,
    write position and fill level as JAX's buffer_add_batch; a sample at
    JAX's indices equals buffer_sample."""
    jb = jrb.ReplayBuffer.create(8, {"x": (2,), "r": ()})
    tb = ReplayBuffer(8, {"x": (2,), "r": ()}, "cpu")
    rng = np.random.RandomState(0)
    for n, want in ((6, (6, 6)), (4, (2, 8)), (5, (7, 8))):
        batch = {"x": rng.normal(size=(n, 2)).astype(np.float32), "r": rng.normal(size=n).astype(np.float32)}
        jb = jrb.buffer_add_batch(jb, {k: jnp.asarray(v) for k, v in batch.items()})
        tb.add_batch({k: torch.tensor(v) for k, v in batch.items()})
        assert (tb.idx, tb.size) == (int(jb.idx), int(jb.size)) == want
        for k in batch:
            np.testing.assert_array_equal(tb.data[k].numpy(), np.asarray(jb.data[k]))
    key = jax.random.PRNGKey(3)
    idx = jax.random.randint(key, (16,), 0, jnp.maximum(jb.size, 1))
    js, ts = jrb.buffer_sample(jb, key, 16), tb.sample(16, idx=torch.tensor(np.asarray(idx)))
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    drawn = tb.sample(5, torch.Generator().manual_seed(0))
    assert drawn["x"].shape == (5, 2) and drawn["r"].shape == (5,)
    empty = ReplayBuffer(4, {"x": ()}, "cpu")
    assert torch.equal(empty.sample(3, torch.Generator())["x"], torch.zeros(3))  # index 0 below an empty fill
    with pytest.raises(ValueError, match="does not fit"):
        empty.add_batch({"x": torch.zeros(5)})


@pytest.mark.parametrize("yaml", ["AntSAC", "HumanoidSAC"])
def test_config_matches_jax(yaml):
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    task = yaml[:-3]
    jc = jsac.SACConfig.from_train_cfg(jload([f"task={task}", f"train={yaml}"])["train"]["params"])
    tc = tsac.SACConfig.from_train_cfg(tload([f"task={task}", f"train={yaml}"])["train"]["params"])
    assert tuple(tc) == tuple(jc) and tc._fields == jc._fields
    assert (tc.batch_size, tc.num_steps_per_episode, tc.replay_buffer_size) == (4096, 8, 1_000_000)


@pytest.mark.parametrize("size, want", [(512, 512), (16, 4 * N)])
def test_buffer_capacity(size, want):
    """min(replay_buffer_size, 4e6 // num_obs * 256), at least 4 num_envs,
    as isaacgymenvs_tpu/learn/sac.py:167-168 sizes it."""
    train = {**TRAIN, "config": {**TRAIN["config"], "replay_buffer_size": size}}
    buf = _agents(train)[1].init().buffer
    assert buf.capacity == want and buf.data["obs"].shape == (want, 4) and buf.data["done"].shape == (want,)


def test_update_matches_jax():
    """Two updates from a buffer of random transitions and a moved
    normalizer, each with JAX's indices and noise: the losses, alpha, and
    every leaf of the actor, the critics, the targets and log alpha at rtol
    2e-4 (the second with Adam moments from the first)."""
    jagent, tagent = _agents()
    jts = jagent.init()
    rng = np.random.RandomState(1)
    m = 40
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    batch = {"obs": f(m, 4), "action": rng.uniform(-1, 1, (m, A)).astype(np.float32), "reward": f(m),
             "next_obs": f(m, 4), "done": (rng.uniform(size=m) < 0.2).astype(np.float32)}
    jts = jts.replace(buffer=jrb.buffer_add_batch(jts.buffer, {k: jnp.asarray(v) for k, v in batch.items()}),
                      obs_rms=jts.obs_rms.replace(mean=jnp.asarray(f(4) * 0.1), var=jnp.asarray(1.0 + f(4) ** 2),
                                                  count=jnp.float32(50.0)))
    tts = _port_from(tagent, jts)
    B = jagent.cfg.batch_size
    for step in range(2):
        key = jax.random.PRNGKey(10 + step)
        k1, k2, k3 = jax.random.split(key, 3)
        idx = jax.random.randint(k1, (B,), 0, jnp.maximum(jts.buffer.size, 1))
        draws = [torch.tensor(np.asarray(jax.random.normal(k, (B, A)))) for k in (k2, k3)]
        jts, jl = jagent._update(jts, key)
        tl = tagent._update(tts, *draws, idx=torch.tensor(np.asarray(idx)))
        for k in ("c_loss", "a_loss", "alpha"):
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=RTOL, atol=ATOL, err_msg=f"update {step} {k}")
        _assert_params_match(tagent, jts, f"update {step}")
    assert float(tagent.log_alpha) != 0.0  # the temperature moved


def _jax_epoch_draws(jagent, jts):
    """The draws JAX's train_epoch makes from its key, step by step."""
    cfg, n, key = jagent.cfg, jagent.env.num_envs, jts.key
    size, total = int(jts.buffer.size), int(jts.total_steps)
    out = {"act": [], "rand": [], "next": [], "pi": []}
    idx = []
    for _ in range(cfg.num_steps_per_episode):
        key, kact, kupd = jax.random.split(key, 3)
        out["rand"].append(jax.random.uniform(kact, (n, A), minval=-1.0, maxval=1.0))
        out["act"].append(jax.random.normal(kact, (n, A)))
        size, total = min(size + n, jts.buffer.capacity), total + 1
        k1, k2, k3 = jax.random.split(kupd, 3)
        idx.append(jax.random.randint(k1, (cfg.batch_size,), 0, max(size, 1)))
        out["next"].append(jax.random.normal(k2, (cfg.batch_size, A)))
        out["pi"].append(jax.random.normal(k3, (cfg.batch_size, A)))
    t = lambda x: torch.tensor(np.stack([np.asarray(y) for y in x]))
    return {k: t(v) for k, v in out.items()}, t(idx)


def test_two_epochs_match_jax():
    """The JAX package's own train_epoch, twice from init (a seed step of
    uniform actions, two warm-up steps, then an update per env step),
    against the port's fed the same draws: the buffer's contents, losses,
    alpha and every parameter at rtol 2e-4."""
    jagent, tagent = _agents()
    jts = jagent.init()
    tts = _port_from(tagent, jts)
    seeded = None
    for epoch in range(2):
        noise, idx = _jax_epoch_draws(jagent, jts)
        seeded = noise["rand"][0] if seeded is None else seeded
        jts, jm = jagent.train_epoch(jts)
        tts, tm = tagent.train_epoch(tts, noise=noise, idx=idx)
        assert tts.total_steps == int(jts.total_steps) == 4 * (epoch + 1)
        assert (tts.buffer.idx, tts.buffer.size) == (int(jts.buffer.idx), int(jts.buffer.size))
        for k, v in jts.buffer.data.items():
            np.testing.assert_allclose(tts.buffer.data[k].numpy(), np.asarray(v), rtol=RTOL, atol=1e-5, err_msg=k)
        for k in ("c_loss", "a_loss", "alpha", "n_episodes"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=RTOL, atol=ATOL, err_msg=f"epoch {epoch} {k}")
        _assert_params_match(tagent, jts, f"epoch {epoch}")
    # the seed step took the uniform draw, the later ones the squashed policy
    assert torch.equal(tts.buffer.data["action"][:N], seeded)
    assert not torch.equal(tts.buffer.data["action"][N:2 * N], noise["rand"][0])


def test_time_outs_are_not_terminal():
    """The buffer's terminal flag is done & ~time_outs: envs at the episode
    end are done but stored as not terminal, a fallen pole as terminal."""
    _, tagent = _agents()
    ts = tagent.init()
    ts.env_state.progress = torch.tensor([498, 498, 10, 10, 10, 10, 10, 10], dtype=torch.int32)
    q = ts.env_state.sim.q.clone()
    q[2, 1] = 1.7  # beyond the pole's limit: this env falls
    ts.env_state.sim = SimState(q=q, qd=ts.env_state.sim.qd)
    cfg = tagent.cfg._replace(num_steps_per_episode=1)
    tagent.cfg = cfg
    ts, m = tagent.train_epoch(ts)
    done = ts.buffer.data["done"][:N]
    assert m["n_episodes"] == 3.0 and done.tolist() == [0, 0, 1, 0, 0, 0, 0, 0]


def test_trains_moves_targets_by_tau_and_fills_the_buffer():
    """The JAX package's training smoke on the port (tests/test_sac.py): 32
    envs, 6 epochs of 8 steps; finite non-negative critic loss, alpha > 0,
    the actor moved, 1,536 transitions in the buffer; after one more update
    the targets are (1 - tau) targets + tau critics."""
    train = {"network": {"mlp": {"units": [32, 32], "activation": "relu"}, "log_std_bounds": [-5, 2]},
             "config": {"batch_size": 128, "num_steps_per_episode": 8, "num_warmup_steps": 2, "num_seed_steps": 1,
                        "reward_shaper": {"scale_value": 0.1}}}
    _, tagent = _agents(train, n=32)
    ts = tagent.init()
    before = [p.detach().clone() for p in tagent.actor.parameters()]
    for _ in range(6):
        ts, m = tagent.train_epoch(ts)
    assert np.isfinite(m["c_loss"]) and m["c_loss"] >= 0 and m["alpha"] > 0
    assert any(not torch.equal(a, b) for a, b in zip(before, tagent.actor.parameters()))
    assert ts.buffer.size == 6 * 8 * 32 and ts.total_steps == 48
    old = [p.detach().clone() for p in tagent.target.parameters()]
    tagent._update(ts)
    tau = tagent.cfg.critic_tau
    for t, o, c in zip(tagent.target.parameters(), old, tagent.critic.parameters()):
        assert torch.equal(t, (1.0 - tau) * o + tau * c.detach())


def test_checkpoint_roundtrip_and_play(tmp_path):
    """save -> restore into an agent of another seed gives back the actor,
    critics, targets, log alpha and normalizer bit for bit; the checkpoint
    holds no optimizer moments and no buffer; play returns a finite mean."""
    _, tagent = _agents()
    ts = tagent.init()
    for _ in range(2):
        ts, _ = tagent.train_epoch(ts)
    path = str(tmp_path / "sac.pth")
    tagent.save(path, ts)
    assert set(load_checkpoint(path)) == {"actor_params", "critic_params", "target_params", "log_alpha", "obs_rms"}
    other = _agents()[1]
    other.seed = 9
    ots = other.restore(path, other.init())
    for a, b in ((tagent.actor, other.actor), (tagent.critic, other.critic), (tagent.target, other.target)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert torch.equal(tagent.log_alpha, other.log_alpha)
    assert all(torch.equal(getattr(ts.obs_rms, f), getattr(ots.obs_rms, f)) for f in ("mean", "var", "count"))
    assert torch.equal(tagent.act(ts, ts.obs), other.act(ots, ts.obs))
    assert np.isfinite(other.play(checkpoint=path, num_episodes=4))
