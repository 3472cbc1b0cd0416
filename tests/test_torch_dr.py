"""The port's domain randomization against the JAX package's, and on its own.

`jax.random` and `torch.Generator` give different streams, so nothing here
compares two draws. The transform of a draw (range, distribution, operation,
schedule) is compared value for value by feeding the JAX package's base
draw through the port's `_transform`; the application of a sample
(`batched_model`, `gravity`) by carrying one JAX sample across with
`convert.dr_sample_from_jax`. What depends on the stream (ranges respected,
`setup_only`, the frequency gate, noise) is checked as properties of the
port alone, mirroring tests/test_dr.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.dr import param_generator as jgen
from isaacgymenvs_tpu.dr import randomize as jdr
from isaacgymenvs_tpu.model import spec as jspec
from isaacgymenvs_tpu_torch.convert import dr_sample_from_jax
from isaacgymenvs_tpu_torch.dr import DomainRandomizer, FullCovarianceParamGenerator, MixtureParamGenerator
from isaacgymenvs_tpu_torch.dr import randomize as tdr
from isaacgymenvs_tpu_torch.model import examples as ex
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.config import load_config
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

PARAMS = {
    "frequency": 5,
    "observations": {"range": [0, 0.002], "operation": "additive", "distribution": "gaussian"},
    "actions": {"range": [0.0, 0.02], "operation": "additive", "distribution": "gaussian"},
    "actor_params": {
        "ant": {
            "color": True,
            "rigid_body_properties": {
                "mass": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform", "setup_only": True}
            },
            "dof_properties": {
                "damping": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"},
                "lower": {"range": [0, 0.01], "operation": "additive", "distribution": "gaussian"},
            },
        }
    },
}


def _env(n=8, params=PARAMS, task="Ant"):
    cfg = load_config([f"task={task}", f"num_envs={n}"])["task"]
    cfg["task"] = {"randomize": True, "randomization_params": params}
    return task_map[task](cfg, device="cpu")


# ---- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("schedule", ["constant", "linear"])
@pytest.mark.parametrize("operation", ["additive", "scaling"])
@pytest.mark.parametrize("distribution", ["uniform", "loguniform", "gaussian"])
def test_transform_matches_jax_given_its_base_draw(distribution, operation, schedule):
    """`_transform` on the JAX package's base draw equals the JAX
    `_sample_spec` of the same key, atol 1e-6; at 40 of 100 schedule steps a
    linear schedule is at strength 0.4, a constant one at full strength."""
    d = {"range": [0.4, 1.7], "operation": operation, "distribution": distribution,
         "schedule": schedule, "schedule_steps": 100}
    jspec_, tspec = jdr._spec_from_dict("x", None, d), tdr._spec_from_dict("x", None, d)
    assert jspec_ == jdr.DRSpec(*tspec)  # the parsed specs agree field for field
    model = ex.tendon_chain_example()
    jrz = jdr.DomainRandomizer(ex.tendon_chain_example(jspec), {})
    trz = DomainRandomizer(model, {}, device="cpu")
    js, ts = jrz._sched_scale(jspec_, jnp.asarray(40.0)), trz._sched_scale(tspec, torch.tensor(40.0))
    assert float(js) == pytest.approx(float(ts)) == pytest.approx(0.4 if schedule == "linear" else 1.0)
    key, shape = jax.random.PRNGKey(3), (16, 5)
    base = jax.random.normal(key, shape) if distribution == "gaussian" else jax.random.uniform(key, shape)
    want = np.asarray(jdr._sample_spec(jspec_, key, shape, js))
    got = tdr._transform(tspec, torch.tensor(np.asarray(base)), ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.std(want) > 1e-3


# two actors on the tendon example model: the box (body 0) and the arm (bodies 1-2)
TWO_ACTORS = {
    "sim_params": {"gravity": {"range": [0, 0.4], "operation": "additive", "distribution": "gaussian"}},
    "actor_params": {
        "box": {
            "scale": {"range": [0.8, 1.2], "operation": "scaling", "distribution": "uniform", "setup_only": True},
            "rigid_body_properties": {
                "mass": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"},
                "inertia": {"range": [0.7, 1.3], "operation": "scaling", "distribution": "loguniform"},
            },
            "rigid_shape_properties": {
                "friction": {"range": [0.7, 1.3], "operation": "scaling", "distribution": "uniform"},
                "restitution": {"range": [0.0, 0.4], "operation": "additive", "distribution": "uniform"},
            },
        },
        "arm": {
            "dof_properties": {
                "damping": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"},
                "stiffness": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "loguniform"},
                "friction": {"range": [0.0, 0.02], "operation": "additive", "distribution": "uniform"},
                "armature": {"range": [0.9, 1.1], "operation": "scaling", "distribution": "uniform"},
                "lower": {"range": [0, 0.01], "operation": "additive", "distribution": "gaussian"},
                "upper": {"range": [0, 0.01], "operation": "additive", "distribution": "gaussian"},
                "effort": {"range": [0.9, 1.1], "operation": "scaling", "distribution": "uniform"},
            },
            "tendon_properties": {
                "stiffness": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"},
                "damping": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"},
            },
            "rigid_body_properties": {
                "mass": {"range": [0.9, 1.1], "operation": "scaling", "distribution": "uniform"},
            },
        },
    },
}
RANGES = {"box": (0, 1), "arm": (1, 3)}


@pytest.mark.parametrize("masked", [False, True], ids=["whole_leaf", "actor_ranges"])
def test_batched_model_matches_jax_given_its_sample(masked):
    """One sample drawn by the JAX randomizer, carried across: the per-env
    leaves, the gravity and the leaf set agree (rtol 1e-6), with every spec
    on the whole leaf and with `dr_actor_ranges` masks; the actor-scale spec
    (which needs the ranges) is in the masked case. param_info and the flat
    layout are equal."""
    params = TWO_ACTORS if masked else {
        **TWO_ACTORS, "actor_params": {a: {g: p for g, p in groups.items() if g != "scale"}
                                       for a, groups in TWO_ACTORS["actor_params"].items()}}
    ranges = RANGES if masked else None
    jm, tm = ex.tendon_chain_example(jspec), ex.tendon_chain_example()
    jrz = jdr.DomainRandomizer(jm, params, actor_ranges=ranges, obs_dim=4, act_dim=2)
    trz = DomainRandomizer(tm, params, actor_ranges=ranges, obs_dim=4, act_dim=2, device="cpu")
    assert [s.name for s in trz.model_specs] == [s.name for s in jrz.model_specs]
    assert [s.name for s in trz.scale_specs] == [s.name for s in jrz.scale_specs] == (["box.scale"] if masked else [])
    assert trz.param_info() == jrz.param_info() and trz.num_extern_params() == jrz.num_extern_params()
    for (ti, tn), (ji, jn) in zip(trz._flat_layout, jrz._flat_layout):
        assert tn == jn
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert trz.batched_leaf_names() == jrz.batched_leaf_names()
    n = 6
    jsample = jrz.sample(jax.random.PRNGKey(5), n, jnp.zeros((), jnp.int32))
    tsample = dr_sample_from_jax({k: np.asarray(v) for k, v in jsample.items()})
    assert set(tsample) == set(trz.identity_sample(n)) == set(trz.sample(torch.Generator().manual_seed(0), n, 0))
    want = jrz.batched_model(jm, jsample)
    got = trz.batched_model(tsample)
    assert set(got) == jrz.batched_leaf_names()
    for leaf, val in got.items():
        ref = np.asarray(getattr(want, leaf))
        assert tuple(val.shape) == ref.shape == (n,) + np.shape(getattr(tm, leaf) if getattr(tm, leaf) is not None else ref[0]), leaf
        np.testing.assert_allclose(val.numpy(), ref, rtol=1e-6, atol=1e-9, err_msg=leaf)
    np.testing.assert_allclose(trz.gravity((0.0, 0.0, -9.81), tsample).numpy(),
                               np.asarray(jrz.gravity(jnp.asarray([0.0, 0.0, -9.81]), jsample)), rtol=1e-6)
    if masked:
        # the box's mass spec leaves the arm's bodies alone, and the other way round
        mass = got["body_mass"].numpy() / np.asarray(tm.body_mass)[None]
        s3 = tsample["box.scale"].numpy() ** 3
        np.testing.assert_allclose(mass[:, 0], tsample["box.rigid_body_properties.mass"].numpy()[:, 0] * s3, rtol=1e-5)
        np.testing.assert_allclose(mass[:, 1:], tsample["arm.rigid_body_properties.mass"].numpy()[:, 1:], rtol=1e-5)
    # the identity sample changes nothing
    for leaf, val in trz.batched_model(trz.identity_sample(n)).items():
        np.testing.assert_allclose(val.numpy(), np.broadcast_to(trz._base[leaf].numpy(), val.shape), rtol=1e-6)


def test_full_covariance_generator_matches_jax_given_its_normal_draw():
    P, n = 5, 64
    rng = np.random.RandomState(0)
    a = rng.normal(size=(P, P))
    cov = (a @ a.T).astype(np.float32) * 1e-2
    mean = rng.uniform(0.8, 1.2, P).astype(np.float32)
    lo, hi = np.full(P, 0.7, np.float32), np.full(P, 1.3, np.float32)
    jg = jgen.FullCovarianceParamGenerator(mean, cov=cov, lo=lo, hi=hi)
    tg = FullCovarianceParamGenerator(mean, cov=cov, lo=lo, hi=hi)
    key = jax.random.PRNGKey(1)
    z = np.asarray(jax.random.normal(key, (n, P)))
    np.testing.assert_allclose(tg.transform(torch.tensor(z)).numpy(), np.asarray(jg(key, n)), atol=1e-6)
    # a positive semi-definite covariance takes the eigen factor in both
    semi = np.zeros((P, P), np.float32)
    semi[0, 0] = 1e-4
    np.testing.assert_allclose(FullCovarianceParamGenerator(mean, cov=semi).transform(torch.tensor(z)).numpy(),
                               np.asarray(jgen.FullCovarianceParamGenerator(mean, cov=semi)(key, n)), atol=1e-6)
    draws = tg(torch.Generator().manual_seed(2), 512)
    assert draws.shape == (512, P) and draws.min() >= lo[0] and draws.max() <= hi[0]
    with pytest.raises(ValueError, match="cov or chol"):
        FullCovarianceParamGenerator(mean)


def test_mixture_generator_matches_jax_given_its_draws():
    """The mixture of Gaussians given the JAX package's component picks and
    normal draws (its `__call__` splits its key into one for each)."""
    K, P, n = 3, 4, 32
    rng = np.random.RandomState(1)
    means = rng.uniform(0.8, 1.2, (K, P)).astype(np.float32)
    chols = np.tril(rng.normal(size=(K, P, P))).astype(np.float32) * 0.05
    weights, lo = np.array([1.0, 2.0, 3.0], np.float32), np.full(P, 0.75, np.float32)
    jg = jgen.MixtureParamGenerator(weights, means, chols, lo=lo)
    tg = MixtureParamGenerator(weights, means, chols, lo=lo)
    key = jax.random.PRNGKey(4)
    kc, kz = jax.random.split(key)
    comp = np.asarray(jax.random.categorical(kc, jg.log_w, shape=(n,)))
    z = np.asarray(jax.random.normal(kz, (n, P)))
    np.testing.assert_allclose(tg.transform(torch.tensor(comp), torch.tensor(z)).numpy(), np.asarray(jg(key, n)), atol=1e-6)
    np.testing.assert_allclose(tg.weights.numpy(), np.exp(np.asarray(jg.log_w)), rtol=1e-6)
    draws = tg(torch.Generator().manual_seed(0), 4000)
    assert draws.shape == (4000, P) and draws.min() >= lo[0]
    # the heaviest component's mean dominates: the sample mean lies nearest the weighted mean
    np.testing.assert_allclose(draws.mean(0).numpy(), (weights[:, None] * means).sum(0) / weights.sum(), atol=0.02)


# ---- properties of the port, mirroring tests/test_dr.py ------------------------


def test_sampling_ranges_and_ops():
    env = _env()
    rz = env.randomizer
    s = rz.sample(torch.Generator().manual_seed(0), 64, 0)
    mass = s["ant.rigid_body_properties.mass"].numpy()
    assert mass.shape == (64, env.model.nbody)
    assert (mass >= 0.5).all() and (mass <= 1.5).all() and mass.std() > 0.1
    leaves = rz.batched_model(s)
    assert set(leaves) == {"body_mass", "dof_damping", "dof_limit_lower"} == rz.batched_leaf_names()
    np.testing.assert_allclose(leaves["body_mass"].numpy(), np.asarray(env.model.body_mass)[None] * mass, rtol=1e-5)
    lower = s["ant.dof_properties.lower"].numpy()
    assert abs(lower.mean()) < 0.002 and 0.005 < lower.std() < 0.02  # gaussian offsets, sigma 0.01
    # ADR overrides of no spec change nothing: the same draws from the same seed
    plain = rz.sample(torch.Generator().manual_seed(0), 4, 0)
    none = rz.sample(torch.Generator().manual_seed(0), 4, 0, adr={})
    assert all(torch.equal(plain[k], none[k]) for k in plain)
    # an override moves its named spec only: mass draws from [0.8, 0.9], env 0 pinned at 1.25, every other
    # draw unchanged (tests/test_torch_adr.py holds the overrides against JAX's)
    name = "ant.rigid_body_properties.mass"
    pin = torch.tensor([True, False, False, False])
    ov = rz.sample(torch.Generator().manual_seed(0), 4, 0,
                   adr={name: {"lo": 0.8, "hi": 0.9, "pin_mask": pin, "pin_val": torch.full((4,), 1.25)}})
    assert all(torch.equal(plain[k], ov[k]) for k in plain if k != name)
    assert bool((ov[name][0] == 1.25).all()) and not torch.equal(ov[name], plain[name])
    assert float(ov[name][1:].min()) >= 0.8 and float(ov[name][1:].max()) <= 0.9


def test_per_env_physics_differs():
    """Envs that start in the same state under the same actions part ways
    when their masses and dampings differ."""
    env = _env(4)
    state, obs = env.reset(1)
    assert state.dyn.names == ("dof_damping", "dof_limit_lower", "body_mass")
    assert state.dyn.rows.shape == (14 + 14 + 9, 4)
    state.sim.q[:] = state.sim.q[0].clone()
    state.sim.qd[:] = state.sim.qd[0].clone()
    for _ in range(5):
        state, obs, rew, done, ex_ = env.step(state, torch.zeros(4, 8))
    assert bool(torch.isfinite(obs).all())
    assert float(state.dr["ant.dof_properties.damping"][:, 6].std()) > 0.0
    assert float(state.sim.qd.std(dim=0).max()) > 1e-3
    assert int(state.frames) == 5


def test_setup_only_persists_and_frequency_gates():
    env = _env(4)
    state, _ = env.reset(2)
    mass0 = state.dr["ant.rigid_body_properties.mass"].clone()
    damp0 = state.dr["ant.dof_properties.damping"].clone()
    dyn0 = state.dyn.rows.clone()
    for i in range(8):
        state.sim.q[0, 2] = 0.0  # below the termination height: env 0 is done, then reset, in turns
        state, _, _, done, _ = env.step(state, torch.zeros(4, 8))
        assert bool(done[0]) == (i % 2 == 0)
        if i < 4:  # the frequency window (5 steps) has not passed: nothing re-randomized
            assert torch.equal(state.dr["ant.dof_properties.damping"], damp0)
            assert torch.equal(state.dyn.rows, dyn0)
    mass1, damp1 = state.dr["ant.rigid_body_properties.mass"], state.dr["ant.dof_properties.damping"]
    assert torch.equal(mass1, mass0)  # setup_only: never resampled
    assert abs(float(damp1[0, 0] - damp0[0, 0])) > 1e-9  # re-randomized at its reset
    assert torch.equal(damp1[1:], damp0[1:])  # the envs that did not reset keep theirs
    # the packed rows follow the sample: env 0's damping rows changed, its mass rows did not
    assert not torch.equal(state.dyn.rows[:14, 0], dyn0[:14, 0]) and torch.equal(state.dyn.rows[28:, 0], dyn0[28:, 0])
    assert torch.equal(state.dyn.rows[:, 1:], dyn0[:, 1:])
    np.testing.assert_allclose(state.dyn.rows[:14].T.numpy(), np.asarray(env.model.dof_damping)[None] * damp1.numpy(), rtol=1e-6)
    # env 0 was re-randomized at its first reset past the window (step 6), the others never
    assert state.randomize_buf.tolist() == [2, 8, 8, 8]


def test_obs_action_noise_applied():
    env = _env(4)
    rz = env.randomizer
    gen = torch.Generator().manual_seed(3)
    y = rz.observation_noise(gen, torch.zeros(4, 10), 0)
    assert 0.0 < float(y.abs().max()) < 0.02  # gaussian sigma 0.002
    a = rz.action_noise(gen, torch.zeros(4, 8), 0)
    assert 0.0 < float(a.abs().max()) < 0.2  # gaussian sigma 0.02
    # through the step: the same state and actions give noised observations
    plain = task_map["Ant"](load_config(["task=Ant", "num_envs=4"])["task"], device="cpu")
    s0, _ = plain.reset(4)
    s1, _ = env.reset(4)
    s1.dr = rz.identity_sample(4)
    s1.dyn = env.pack_dyn(s1.dr)
    act = torch.full((4, 8), 0.3)
    _, o0, _, _, _ = plain.step(s0, act)
    _, o1, _, _, _ = env.step(s1, act)
    diff = (o1 - o0).abs()
    assert 1e-5 < float(diff[:, :52].max()) < 0.5  # physics under noised actions, plus observation noise
    assert 1e-4 < float(diff[:, 52:].max()) < 0.2  # the observed actions carry the action noise


def test_correlated_noise_held_between_rerandomizations():
    params = {
        "frequency": 10_000,  # never re-randomized in this test
        "observations": {"range": [0, 1e-6], "range_correlated": [0, 0.5],
                         "operation": "additive", "distribution": "gaussian"},
    }
    cfg = {"env": {"numEnvs": 4, "clipActions": 1.0, "clipObservations": 100.0},
           "sim": {"dt": 1 / 60, "substeps": 2},
           "task": {"randomize": True, "randomization_params": params}}
    env = task_map["Cartpole"](cfg, device="cpu")
    assert env.randomizer.obs_spec.corr_hi == 0.5
    state, obs = env.reset(0)
    corr = state.dr["observations_corr"].clone()
    assert corr.shape == (4, env.num_obs) and float(corr.std()) > 0.1
    assert state.dyn is None  # no model leaf is randomized: the physics step takes no per-env rows
    plain = task_map["Cartpole"]({k: v for k, v in cfg.items() if k != "task"}, device="cpu")
    p0, _ = plain.reset(0)
    zero = torch.zeros(4, 1)
    for _ in range(2):
        state, obs, *_ = env.step(state, zero)
        p0, pobs, *_ = plain.step(p0, zero)
        assert torch.equal(state.dr["observations_corr"], corr)  # held fixed between resets
        np.testing.assert_allclose((obs - pobs).numpy(), corr.numpy(), atol=1e-4)  # offset = the correlated draw


def test_per_key_observation_noise():
    """Per-obs-key noise dicts noise only their slice of the flat obs vector."""
    params = {"observations": {
        "dof_pos": {"range": [0, 0.01], "operation": "additive", "distribution": "gaussian"},
        "goal": {"range": [0, 0.01], "range_correlated": [0, 0.1], "operation": "additive", "distribution": "gaussian"},
        "absent": {"range": [0, 0.01], "operation": "additive", "distribution": "gaussian"},
    }}
    slices = {"dof_pos": (0, 3), "goal": (5, 2), "other": (7, 3)}
    rz = DomainRandomizer(ex.tendon_chain_example(), params, obs_dim=10, act_dim=2, obs_slices=lambda: slices,
                          device="cpu")
    assert set(rz.obs_key_specs) == {"dof_pos", "goal", "absent"} and rz.obs_spec is None
    gen = torch.Generator().manual_seed(0)
    sample = rz.sample(gen, 4, 0)
    assert set(sample) == {"observations_corr.goal"} and sample["observations_corr.goal"].shape == (4, 2)
    obs = torch.zeros(4, 10)
    out = rz.observation_noise(gen, obs, 0, dr_sample=sample).numpy()
    assert float(obs.abs().max()) == 0.0  # the input is left as it was
    assert np.abs(out[:, 0:3]).max() > 0 and np.abs(out[:, 5:7]).max() > 0.01
    assert np.abs(out[:, 3:5]).max() == 0 and np.abs(out[:, 7:]).max() == 0


def test_external_param_generator():
    env = _env(4)
    info = env.get_actor_params_info()
    assert [i["name"] for i in info] == [s.name for s in env.randomizer.model_specs]
    P = env.randomizer.num_extern_params()
    assert P == sum(i["size"] for i in info) == 9 + 14 + 14
    # a zero-covariance generator: every factor is exactly the mean
    mean = np.full(P, 1.25, np.float32)
    off = 0
    for i in info:
        if i["operation"] == "additive":
            mean[off:off + i["size"]] = 0.0
        off += i["size"]
    env.set_param_generator(FullCovarianceParamGenerator(mean, cov=np.zeros((P, P))))
    s = env.randomizer.sample(torch.Generator().manual_seed(0), 4, 0)
    np.testing.assert_allclose(s["ant.rigid_body_properties.mass"].numpy(), 1.25, rtol=1e-6)
    np.testing.assert_allclose(env.randomizer.batched_model(s)["body_mass"].numpy(),
                               np.broadcast_to(np.asarray(env.model.body_mass) * 1.25, (4, 9)), rtol=1e-5)
    # full-covariance draws correlate parameters
    cov = np.eye(P, dtype=np.float32) * 1e-4
    cov[0, 1] = cov[1, 0] = 1e-4
    draws = FullCovarianceParamGenerator(np.ones(P), cov=cov)(torch.Generator().manual_seed(1), 512).numpy()
    assert np.corrcoef(draws[:, 0], draws[:, 1])[0, 1] > 0.95
    # end to end: reset consumes the generator
    state, obs = env.reset(2)
    np.testing.assert_allclose(state.dr["ant.rigid_body_properties.mass"].numpy(), 1.25, rtol=1e-6)
    assert bool(torch.isfinite(obs).all())
    env.set_param_generator(lambda gen, n: torch.ones(n, 3))
    with pytest.raises(ValueError, match="expected"):
        env.reset(0)
    with pytest.raises(TypeError):
        env.set_param_generator(3)
    plain = task_map["Ant"](load_config(["task=Ant", "num_envs=4"])["task"], device="cpu")
    assert plain.randomizer is None and plain.get_actor_params_info() is None
    with pytest.raises(ValueError, match="randomize"):
        plain.set_param_generator(lambda gen, n: None)


def test_linear_schedule_ramps_from_identity():
    params = {"actor_params": {"a": {"dof_properties": {"damping": {
        "range": [2.0, 2.0], "operation": "scaling", "distribution": "uniform",
        "schedule": "linear", "schedule_steps": 10}}}}}
    rz = DomainRandomizer(ex.tendon_chain_example(), params, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for frames, want in ((0, 1.0), (5, 1.5), (10, 2.0), (40, 2.0)):
        v = rz.sample(gen, 3, torch.tensor(frames, dtype=torch.int32))["a.dof_properties.damping"]
        np.testing.assert_allclose(v.numpy(), want, rtol=1e-6)


RANDOMIZE_ANY = {
    "frequency": 2,
    "observations": {"range": [0, 0.002], "operation": "additive", "distribution": "gaussian"},
    "sim_params": {"gravity": {"range": [0, 0.4], "operation": "additive", "distribution": "gaussian"}},
    "actor_params": {"robot": {
        "rigid_body_properties": {"mass": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"}},
        "rigid_shape_properties": {"friction": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"}},
        "dof_properties": {"damping": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "loguniform"}},
    }},
}


@pytest.mark.parametrize("task", ["Ant", "Cartpole", "Ingenuity", "Quadcopter", "BallBalance"])
def test_every_ported_task_steps_with_randomization(task):
    """`task.randomize=True` through the config: Ant with the block its yaml
    carries, the others with one passed in. Three steps on the CPU; the state
    carries the sample, its packed rows and the counters."""
    cfg = load_config([f"task={task}", "num_envs=4", "task.randomize=True"])["task"]
    assert cfg["task"]["randomize"] is True
    if task == "Ant":
        assert cfg["task"]["randomization_params"]["frequency"] == 600
    else:
        cfg["task"]["randomization_params"] = RANDOMIZE_ANY
    env = task_map[task](cfg, device="cpu")
    state, obs = env.reset(0)
    want = (("dof_damping", "dof_stiffness", "dof_limit_lower", "dof_limit_upper", "body_mass") if task == "Ant"
            else ("dof_damping", "body_mass", "cpoint_friction", "gravity"))
    assert state.dyn.names == want
    for _ in range(3):
        state, obs, rew, done, _ = env.step(state, torch.zeros(4, env.num_acts))
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(state.sim.q).all())
    assert int(state.frames) == 3 and state.randomize_buf.dtype == torch.int32
    assert state.dyn.rows.shape[1] == 4 and state.dyn.rows.dtype == torch.float32
    env.set_train_info(12345)
    assert env.total_train_env_frames == 12345


def test_adr_and_unported_leaf_combinations_raise():
    # ADR is ported: an adr block with use_adr gives the env its ADR engine (here without parameters)
    cfg = load_config(["task=Ant", "num_envs=4"])["task"]
    cfg["env"]["adr"] = {"use_adr": True}
    env = task_map["Ant"](cfg, device="cpu")
    assert env.adr is not None and env.adr.P == 0 and not env.adr_load_from_checkpoint
    with pytest.raises(ValueError, match="dr_actor_ranges"):
        _env(4, {"actor_params": {"ant": {"scale": {"range": [0.9, 1.1], "operation": "scaling"}}}})
