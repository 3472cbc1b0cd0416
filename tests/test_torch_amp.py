"""The port's AMP stack against the JAX package: the maths it adds, the
hand-written AMP humanoid (`assets/mjcf/amp_humanoid.xml`) through both
MJCF parsers, the generated clip (`assets/amp/motions/amp_humanoid_run.npy`)
through both motion libraries, the HumanoidAMP env (reset, three steps,
demo windows), the AMP agent's reward shaping and discriminator loss, and
one whole AMP epoch; and the counterparts of tests/test_amp.py.

The JAX side reaches the bundled assets through $ISAACGYMENVS_TPU_ASSETS.
Its env steps run op by op with its fused physics math (`use_fused`), as in
tests/test_torch_humanoid.py; random draws (motion ids, times, demo
windows, action noise, permutations) are the JAX package's, handed to the
port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 4
CFG = {"env": {"numEnvs": N, "clipActions": 1.0, "clipObservations": 5.0},
       "sim": {"dt": 0.0166, "substeps": 2, "physx": {"max_active_contacts": 16}}}
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
AMP_TRAIN = {"network": {"separate": True, "mlp": {"units": [32, 16], "activation": "relu"},
                         "space": {"continuous": {"sigma_init": {"val": -1.0}, "learn_sigma": False}},
                         "disc": {"units": [32, 16], "activation": "relu"}},
             "config": {"horizon_length": 2, "minibatch_size": 4, "mini_epochs": 2, "amp_minibatch_size": 4,
                        "learning_rate": 1e-3, "lr_schedule": "constant", "truncate_grads": True, "grad_norm": 0.5,
                        "normalize_value": True, "value_bootstrap": True, "bounds_loss_coef": 10,
                        "critic_coef": 5, "clip_value": False, "disc_coef": 5, "disc_grad_penalty": 5,
                        "disc_logit_reg": 0.05, "disc_weight_decay": 1e-4, "disc_reward_scale": 2}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def envs():
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["HumanoidAMP"]({"env": dict(CFG["env"]), "sim": {**CFG["sim"], "use_fused": True}})
        tenv = ttasks["HumanoidAMP"]({k: dict(v) for k, v in CFG.items()}, device="cpu")
    return jenv, tenv


# ---- maths ---------------------------------------------------------------

def _unit(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_maths_additions_match_jax():
    """quat_slerp (random pairs, antipodal ones, near-equal ones where the
    linear branch runs, t at both ends), calc_heading_quat_inv and
    quat_to_tan_norm against the JAX package at 1e-6."""
    from isaacgymenvs_tpu import maths as jm
    from isaacgymenvs_tpu_torch import maths as tm

    rng = np.random.RandomState(0)
    q0, q1 = _unit(rng, 64), _unit(rng, 64)
    q1[:8] = -q0[:8]  # antipodal: the same rotation
    near = q0[8:16] + 1e-5 * rng.normal(size=(8, 4)).astype(np.float32)
    q1[8:16] = near / np.linalg.norm(near, axis=-1, keepdims=True)
    t = rng.uniform(0, 1, 64).astype(np.float32)
    t[16:20], t[20:24] = 0.0, 1.0
    close = lambda a, b: np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-6)
    close(jm.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)),
          tm.quat_slerp(torch.tensor(q0), torch.tensor(q1), torch.tensor(t)))
    close(jm.calc_heading_quat_inv(jnp.asarray(q0)), tm.calc_heading_quat_inv(torch.tensor(q0)))
    close(jm.quat_to_tan_norm(jnp.asarray(q0)), tm.quat_to_tan_norm(torch.tensor(q0)))
    # the heading inverse undoes the heading; slerp ends at its ends
    yaw = tm.quat_mul(tm.calc_heading_quat_inv(torch.tensor(q0)), tm.calc_heading_quat(torch.tensor(q0)))
    assert torch.allclose(yaw[:, 3].abs(), torch.ones(64), atol=1e-6)
    ends = tm.quat_slerp(torch.tensor(q0), torch.tensor(q1), torch.ones(64))
    assert torch.allclose(ends.abs(), torch.tensor(q1).abs(), atol=1e-6)


# ---- the model and the clip ------------------------------------------------

def test_model_matches_jax(envs):
    """Every field of the parsed stand-in equal within 1e-6 in both
    parsers, and its facts: 15 named bodies in the skeleton's order, eight
    of them with three joints (16 `__f` links, 31 in all), nq 35, nv 34, 28
    scalar dofs and motors, a free root, 42 candidates, abdomen stiffness
    600 and damping 60, a mass of 40-60 kg; and the 28 dofs grouped into 12
    clusters as the task groups them."""
    from isaacgymenvs_tpu_torch.model.spec import FREE, Model

    jenv, tenv = envs
    jm, tm = jenv.model, tenv.model
    for f in dataclasses.fields(Model):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if a is None or isinstance(a, (bool, int, str)) or (isinstance(a, tuple) and not any(
                hasattr(x, "shape") for x in a)):
            assert a == b or tuple(a) == tuple(b), f.name
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=1e-6,
                                       err_msg=f.name)
    assert (tm.nbody, tm.nq, tm.nv, tm.nu, tm.ncp) == (31, 35, 34, 28, 42)
    named = [n for n in tm.body_names if "__f" not in n]
    assert named == ["pelvis", "torso", "head", "right_upper_arm", "right_lower_arm", "right_hand",
                     "left_upper_arm", "left_lower_arm", "left_hand", "right_thigh", "right_shin", "right_foot",
                     "left_thigh", "left_shin", "left_foot"]
    assert tm.jnt_type[0] == FREE and sum("__f" in n for n in tm.body_names) == 16
    names = tm.dof_joint_names()
    assert float(tm.dof_stiffness[names.index("abdomen_x")]) == pytest.approx(600.0)
    assert float(tm.dof_damping[names.index("abdomen_x")]) == pytest.approx(60.0)
    assert 40.0 < float(np.sum(tm.body_mass)) < 60.0
    assert tenv.cluster_names == jenv.cluster_names and tenv.dof_offsets == jenv.dof_offsets
    assert len(tenv.cluster_names) == 12
    for a in ("pd_offset", "pd_scale"):
        np.testing.assert_allclose(getattr(tenv, a).numpy(), np.asarray(getattr(jenv, a)), atol=1e-6)


def test_motion_clip_layout_and_libraries_match(envs):
    """The generated clip has the SkeletonMotion layout of the stand-in's
    skeleton; both motion libraries preprocess it to the same arrays
    (1e-6), and `get_motion_state` on the same ids and times agrees within
    1e-5 (times beyond both ends clamped); the clip's 3-joint clusters stay
    off the euler singularity, and `convert.motion_lib_from_arrays` carries
    the JAX library's arrays across."""
    from isaacgymenvs_tpu_torch.convert import motion_lib_from_arrays

    jenv, tenv = envs
    jl, tl = jenv.motion_lib, tenv.motion_lib
    d = np.load(f"{package_asset_root()}/amp/motions/amp_humanoid_run.npy", allow_pickle=True).item()
    T = d["rotation"]["arr"].shape[0]
    assert d["rotation"]["arr"].shape == (T, 15, 4) and d["root_translation"]["arr"].shape == (T, 3)
    assert d["global_velocity"]["arr"].shape == d["global_angular_velocity"]["arr"].shape == (T, 15, 3)
    tree = d["skeleton_tree"]
    assert list(tree["node_names"]) == [n for n in tenv.model.body_names if "__f" not in n]
    assert tree["local_translation"]["arr"].shape == (15, 3) and int(d["fps"]) == 30
    names = ("root_pos", "root_rot", "dof_pos", "dof_vel", "key_pos", "root_vel", "root_ang_vel")
    for k in names:
        np.testing.assert_allclose(getattr(tl, k).numpy(), np.asarray(getattr(jl, k)), atol=1e-6, err_msg=k)
    assert float(np.abs(np.asarray(jl.dof_pos)[:, [o + 1 for o in jenv.dof_offsets[:-1]
                                                 if o + 3 in jenv.dof_offsets]]).max()) < 1.0
    ids = np.zeros(16, np.int32)
    times = np.concatenate([[-0.1, 0.0, 2.4, 3.0], np.random.RandomState(0).uniform(0, 2.4, 12)]).astype(np.float32)
    want = jl.get_motion_state(jnp.asarray(ids), jnp.asarray(times))
    conv = motion_lib_from_arrays(_np_tree({k: getattr(jl, k) for k in (*names, "_fps", "_lengths", "_weights",
                                                                        "_starts")}), "cpu")
    for lib in (tl, conv):
        got = lib.get_motion_state(torch.tensor(ids, dtype=torch.int64), torch.tensor(times))
        for k, a, b in zip(names, got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=k)


# ---- the counterparts of tests/test_amp.py ----------------------------------

def _port_env(n, **env_kw):
    from isaacgymenvs_tpu_torch.tasks import task_map

    return task_map["HumanoidAMP"]({"env": {**CFG["env"], "numEnvs": n, **env_kw}, "sim": dict(CFG["sim"])},
                                   device="cpu")


def test_motion_lib_state_query(envs):
    ml = envs[1].motion_lib
    mids = torch.zeros(4, dtype=torch.int64)
    times = torch.tensor([0.0, 0.3, 0.7, 1.0])
    rp, rr, dp, dv, rv, rav, kp = ml.get_motion_state(mids, times)
    assert rp.shape == (4, 3) and dp.shape == (4, 28) and kp.shape == (4, 4, 3)
    assert bool(torch.isfinite(dp).all())
    torch.testing.assert_close(torch.linalg.vector_norm(rr, dim=-1), torch.ones(4), atol=1e-5, rtol=0)
    rp2, *_ = ml.get_motion_state(mids, times + 1e-3)
    assert float((rp2 - rp).abs().max()) < 0.05


def test_reference_state_init_matches_motion():
    """Reset poses drawn from the clip have running-human root heights."""
    env = _port_env(16)
    state, _ = env.reset(0)
    z = state.sim.q[:, 2]
    assert bool(((z > 0.5) & (z < 1.3)).all()), z


def test_amp_obs_history():
    env = _port_env(4)
    state, _ = env.reset(1)
    state, obs, rew, done, ex = env.step(state, torch.zeros(4, 28))
    assert ex["amp_obs"].shape == (4, 210) and bool(torch.isfinite(ex["amp_obs"]).all())
    assert bool((rew == 1.0).all())
    # the window is [current frame, previous frame]; the current one is the
    # observation, which is clipped to clipObservations
    torch.testing.assert_close(torch.clamp(ex["amp_obs"][:, :105], -5.0, 5.0), obs, atol=1e-6, rtol=0)


def test_amp_agent_disc_learns_to_separate():
    from isaacgymenvs_tpu_torch.learn import AMPAgent

    env = _port_env(16)
    tp = {"network": {"mlp": {"units": [64, 64]}, "disc": {"units": [64, 64]}},
          "config": {"horizon_length": 4, "minibatch_size": 64, "mini_epochs": 2, "amp_minibatch_size": 64,
                     "learning_rate": 1e-3, "lr_schedule": "constant"}}
    agent = AMPAgent(env, tp, seed=0)
    ts = agent.init()
    for _ in range(8):
        ts, m = agent.train_epoch(ts)
    assert np.isfinite(m["kl"]) and m["disc_reward_mean"] > 0.0 and 0.0 <= m["disc_acc"] <= 1.0


# ---- the env against the JAX package ------------------------------------------

def _jax_draws(jenv, key):
    """The motion ids and times of `jenv.reset(key)`'s sample_init, per env."""
    _, sub = jax.random.split(key)
    mids, times = [], []
    for k in jax.random.split(sub, jenv.num_envs):
        kmot, kt, _, _ = jax.random.split(k, 4)
        mid = jenv.motion_lib.sample_motions(kmot, ())
        mids.append(int(mid))
        times.append(float(jenv.motion_lib.sample_time(kt, mid[None])[0]))
    return torch.tensor(mids), torch.tensor(times, dtype=torch.float32)


def _task(jtask):
    return {"prev_amp": _t(jtask["prev_amp"])}


def test_reset_matches_jax(envs):
    """The port's init from the JAX reset's draws equals the JAX reset
    state (q, qd, the AMP window: 1e-5) and its observation (1e-5)."""
    jenv, tenv = envs
    key = jax.random.PRNGKey(0)
    jstate, jobs = jenv.reset(key)
    q, qd, task = tenv.init_from_draws(*_jax_draws(jenv, key))
    np.testing.assert_allclose(q.numpy(), np.asarray(jstate.sim.q), atol=1e-5)
    np.testing.assert_allclose(qd.numpy(), np.asarray(jstate.sim.qd), atol=1e-5)
    np.testing.assert_allclose(task["prev_amp"].numpy(), np.asarray(jstate.task["prev_amp"]), atol=1e-5)
    obs = tenv.observe(q, qd, tenv._kin(q, qd), tenv._no_sensors(N), task, None, None)
    np.testing.assert_allclose(torch.clamp(obs, -5, 5).numpy(), np.asarray(jobs), atol=1e-5)


def _recorder(mp, module, sink):
    orig = module.physics_step_fused

    def record(*a, **k):
        out = orig(*a, **k)
        sink.append(out)
        return out

    mp.setattr(module, "physics_step_fused", record)


def _active(tenv, q):
    """Candidates within the contact margin at q, per env."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics

    m = tenv.model
    kin = forward_kinematics(m, q, torch.zeros(q.shape[0], m.nv))
    cb = torch.tensor(m.cpoint_body)
    z = kin.x[:, cb, 2] + maths.quat_rotate(kin.quat[:, cb], torch.tensor(np.asarray(m.cpoint_pos)))[..., 2]
    return (z - torch.tensor(np.asarray(m.cpoint_radius)) < tenv.sim_params.contact_margin).sum(1)


def test_step_matches_jax(envs):
    """Three env steps (one physics call each: controlFrequencyInv 1 here,
    the yaml's 2 runs on the card) from three states of the clip and one of
    the humanoid lying on its back with more candidates in the margin than the top-K cap
    of 16, under small random PD targets, against the JAX step op by op:
    q 2e-4, qd 2e-3, observation and AMP window 2e-2, reward equal to 1,
    done and the time-outs equal; the lying env terminates in the second
    step and is reset in the third (to the JAX package's reset state, handed
    over). The forces of the port step's first physics call against the
    JAX package's fused step on the same inputs: 2e-2."""
    from isaacgymenvs_tpu.engine import fused as jfused
    from isaacgymenvs_tpu_torch.engine import fused as tfused

    jenv, tenv = envs
    jstate, _ = jenv.reset(jax.random.PRNGKey(1))
    q, qd = tenv.standing_states(N, seed=2)
    ql, qdl = tenv.lying_states(8, seed=3)
    lying = int(torch.argmax(_active(tenv, ql)))
    q[0], qd[0] = ql[lying], qdl[lying]
    assert int(_active(tenv, q[:1])[0]) > 16, "the lying env must bind the cap"
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q.numpy()), qd=jnp.asarray(qd.numpy())))
    tstate, _ = tenv.reset(0)
    tstate.sim = SimState(q=q.clone(), qd=qd.clone())
    tstate.task = _task(jstate.task)
    rng = np.random.RandomState(4)
    tout = []
    dones = []
    with pytest.MonkeyPatch.context() as mp:
        _recorder(mp, tfused, tout)
        for k in range(3):
            a = rng.uniform(-0.05, 0.05, (N, 28)).astype(np.float32)
            if k == 0:
                qt = jnp.zeros((N, jenv.model.nq)).at[:, jenv.dof_q_idx].set(jenv.pd_offset + jenv.pd_scale * a)
                jphys = jfused.physics_step_fused(jenv.model, jenv.sim_params, jstate.sim.q, jstate.sim.qd,
                                                  jnp.zeros((N, jenv.model.nv)),
                                                  xfrc=jnp.zeros((N, jenv.model.nbody, 6)), q_target=qt,
                                                  use_pallas=False)
            jstate, jobs, jrew, jdone, jex = jenv.step(jstate, jnp.asarray(a))
            # envs done in the last step reset to the JAX package's draw
            mp.setattr(tenv, "resample_init", lambda g, old, s=jstate: (_t(s.sim.q), _t(s.sim.qd), _task(s.task)))
            tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
            if k == 0:
                for f, tol in TOL.items():
                    np.testing.assert_allclose(getattr(tout[0], f).numpy(), np.asarray(getattr(jphys, f)), atol=tol,
                                               err_msg=f)
                assert float(tout[0].body_force[0].norm(dim=-1).sum()) > 100.0  # the lying one is pushed out
            np.testing.assert_allclose(tstate.sim.q.numpy(), np.asarray(jstate.sim.q), atol=TOL["q"])
            np.testing.assert_allclose(tstate.sim.qd.numpy(), np.asarray(jstate.sim.qd), atol=TOL["qd"])
            np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=2e-2, err_msg=f"step {k} obs")
            np.testing.assert_allclose(tex["amp_obs"].numpy(), np.asarray(jex["amp_obs"]), atol=2e-2,
                                       err_msg=f"step {k} amp_obs")
            np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
            np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
            np.testing.assert_array_equal(tex["time_outs"].numpy(), np.asarray(jex["time_outs"]))
            dones.append(tdone.clone())
    assert len(tout) == 3 and not bool(dones[0][0]) and bool(dones[1][0])


def test_amp_obs_demo_matches_jax(envs):
    """`amp_obs_demo_at` on the motion ids and start times that JAX's
    `fetch_amp_obs_demo` draws equals its windows (1e-5), start times below
    the window's length included; the port's own draw has the shape and
    the clip's root heights."""
    jenv, tenv = envs
    key = jax.random.PRNGKey(5)
    want = jenv.fetch_amp_obs_demo(key, 64)
    k1, k2 = jax.random.split(key)
    mids = jenv.motion_lib.sample_motions(k1, (64,))
    t0 = jenv.motion_lib.sample_time(k2, mids)
    assert float(jnp.min(t0)) < jenv.dt  # the clamp to the window's length acts
    got = tenv.amp_obs_demo_at(torch.tensor(np.asarray(mids), dtype=torch.int64), _t(t0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    own = tenv.fetch_amp_obs_demo(torch.Generator().manual_seed(0), 32)
    assert own.shape == (32, 210) and bool(((own[:, 0] > 0.5) & (own[:, 0] < 1.3)).all())


# ---- the AMP agent against the JAX package --------------------------------------

@pytest.fixture(scope="module")
def agents(envs):
    from isaacgymenvs_tpu.learn import AMPAgent as JAMP
    from isaacgymenvs_tpu_torch.learn import AMPAgent as TAMP

    return JAMP(envs[0], AMP_TRAIN, seed=0), TAMP(envs[1], AMP_TRAIN, seed=0)


def _jax_init(agent):
    """`AMPAgent.init` of the JAX package without PPO.init's probe of the
    step's extras (an abstract trace of the whole env step)."""
    from isaacgymenvs_tpu.learn import ppo as jppo
    from isaacgymenvs_tpu.learn import running_stats as jrs

    key, knet, _, kenv = jax.random.split(jax.random.PRNGKey(agent.seed), 4)
    env_state, obs = agent.env.reset(kenv)
    key, kd = jax.random.split(key)
    params = {"policy": agent.network.init(knet, obs[:1]),
              "disc": agent.disc_net.init(kd, jnp.zeros((1, agent.num_amp_obs))),
              "amp_rms": jrs.RunningMeanStd.create((agent.num_amp_obs,))}
    n = agent.env.num_envs
    return jppo.PPOTrainState(
        params=params, opt_state=agent.tx.init(params), lr=jnp.asarray(agent.cfg.learning_rate),
        obs_rms=jrs.RunningMeanStd.create((agent.env.num_obs,)), value_rms=jrs.RunningMeanStd.create(()),
        env_state=env_state, obs=obs, key=key, ep_return=jnp.zeros(n), ep_len=jnp.zeros(n, jnp.int32))


def _adam(opt_state):
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s
    raise ValueError("no Adam state")


def _port_state_from(tagent, jts):
    from isaacgymenvs_tpu_torch.convert import train_state_from_jax

    adam = _adam(jts.opt_state)
    params = {**jts.params, "amp_rms": vars(jts.params["amp_rms"])}
    fields = _np_tree({"params": params, "obs_rms": vars(jts.obs_rms), "value_rms": vars(jts.value_rms),
                       "lr": jts.lr, "mu": {k: adam.mu[k] for k in ("policy", "disc")},
                       "nu": {k: adam.nu[k] for k in ("policy", "disc")}, "count": adam.count})
    ts = tagent.load_state(tagent.init(), train_state_from_jax(fields, [n for n, _ in tagent.named_trainables()]))
    ts.env_state.sim = SimState(q=_t(jts.env_state.sim.q), qd=_t(jts.env_state.sim.qd))
    ts.env_state.task = _task(jts.env_state.task)
    ts.obs = _t(jts.obs)
    return ts


def _port_params(tagent):
    return {n: p.detach().numpy() for n, p in tagent.named_trainables()}


def _jax_params(params):
    from isaacgymenvs_tpu_torch.convert import actor_critic_from_flax

    return {**{k: v.numpy() for k, v in actor_critic_from_flax(_np_tree(params["policy"])).items()},
            **{f"disc.{k}": v.numpy() for k, v in actor_critic_from_flax(_np_tree(params["disc"])).items()}}


def test_shape_rewards_and_disc_loss_match_jax(agents):
    """`shape_rollout_rewards` (amp_rms update, style reward, mix) and
    `extra_loss` (BCE, gradient penalty, logit and weight decay terms,
    disc_coef) with its gradient per discriminator parameter, on the same
    weights and windows: rtol 1e-5."""
    from isaacgymenvs_tpu.learn import ppo as jppo
    from isaacgymenvs_tpu_torch.learn.ppo import Transition

    jagent, tagent = agents
    jts = _jax_init(jagent)
    tts = _port_state_from(tagent, jts)
    rng = np.random.RandomState(6)
    amp = rng.normal(0.3, 1.5, (3, N, 210)).astype(np.float32)
    rew = rng.normal(size=(3, N)).astype(np.float32)
    z = jnp.zeros(())
    jtraj = jppo.Transition(obs=z, action=z, states=z, extras={"amp_obs": jnp.asarray(amp)}, mu=z, sigma=z, logp=z,
                            value=z, reward=jnp.asarray(rew), done=z, ep_ret_done=z, ep_len_done=z, n_done=z)
    jts2, jtraj2, jaux = jagent.shape_rollout_rewards(jts, jtraj)
    zt = torch.zeros(())
    ttraj = Transition(obs=zt, action=zt, mu=zt, sigma=zt, logp=zt, value=zt, reward=torch.tensor(rew), done=zt,
                       ep_ret_done=zt, ep_len_done=zt, n_done=zt, extras={"amp_obs": torch.tensor(amp)})
    tts2, ttraj2, taux = tagent.shape_rollout_rewards(tts, ttraj)
    np.testing.assert_allclose(ttraj2.reward.numpy(), np.asarray(jtraj2.reward), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(taux["disc_reward_mean"]), float(jaux["disc_reward_mean"]), rtol=1e-5)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tts2.amp_rms, f).numpy(), np.asarray(getattr(jts2.params["amp_rms"], f)),
                                   rtol=1e-5, atol=1e-6)
    agent_w, demos = amp[0], rng.normal(-0.2, 1.0, (N, 210)).astype(np.float32)
    jloss = lambda p: jagent.extra_loss(p, (jnp.asarray(agent_w), jnp.asarray(demos)))
    (jval, jacc), jgrad = jax.value_and_grad(jloss, has_aux=True)(jts2.params)
    nrm = lambda x: tagent._norm_amp(tts2.amp_rms, torch.tensor(x))
    tval, tacc = tagent.extra_loss((nrm(agent_w), nrm(demos)))
    tagent.disc.zero_grad()
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    assert float(tacc["disc_acc"]) == float(jacc["disc_acc"])
    want = _jax_params({"policy": jgrad["policy"], "disc": jgrad["disc"]})
    for n, p in tagent.disc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[f"disc.{n}"], rtol=1e-5, atol=1e-7, err_msg=n)


def _jax_amp_epoch(agent, ts, noise, perms):
    """One AMP epoch of the JAX package given noise and permutations, in the
    order of isaacgymenvs_tpu/learn/ppo.py train_epoch with AMPAgent's
    hooks, the env stepped op by op. Returns (ts, metrics, the demos)."""
    from isaacgymenvs_tpu.learn import ppo as jppo
    from isaacgymenvs_tpu.learn import running_stats as jrs

    cfg, pol = agent.cfg, ts.params["policy"]
    env_state, obs, obs_rms = ts.env_state, ts.obs, ts.obs_rms
    rows, amps = [], []
    for t in range(cfg.horizon_length):
        obs_rms = jrs.rms_update(obs_rms, obs)
        mu, ls, v = agent.network.apply(pol, jrs.rms_normalize(obs_rms, obs))
        value = jrs.rms_denormalize(ts.value_rms, v)
        action = mu + jnp.exp(ls) * noise[t]
        env_state, next_obs, reward, done, extras = agent.env.step(env_state, action)
        shaped = reward * cfg.reward_scale + cfg.gamma * value * extras["time_outs"]
        rows.append((obs, action, mu, ls, jppo._gaussian_logp(action, mu, ls), value, shaped, done))
        amps.append(extras["amp_obs"])
        obs = next_obs
    o, a, m, s, lp, val, rew, dn = (jnp.stack(x) for x in zip(*rows))
    z = jnp.zeros(())
    traj = jppo.Transition(obs=o, action=a, states=z, extras={"amp_obs": jnp.stack(amps)}, mu=m, sigma=s, logp=lp,
                           value=val, reward=rew, done=dn, ep_ret_done=z, ep_len_done=z, n_done=jnp.sum(dn))
    ts = ts.replace(obs_rms=obs_rms)
    ts, traj, aux = agent.shape_rollout_rewards(ts, traj)
    last = jrs.rms_denormalize(ts.value_rms, agent.network.apply(pol, jrs.rms_normalize(obs_rms, obs))[2])
    advantages, returns = agent._gae(traj, last)
    value_rms = jrs.rms_update(jrs.rms_update(ts.value_rms, traj.value), returns)
    old_vnorm = jrs.rms_normalize(value_rms, traj.value, clip=np.inf)
    ret_norm = jrs.rms_normalize(value_rms, returns, clip=np.inf)
    B = agent.batch_size
    flat = lambda x: x.reshape((B,) + x.shape[2:])
    adv = flat(advantages)
    adv = (adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-8)
    dataset = (flat(jrs.rms_normalize(obs_rms, o)), jnp.zeros((B, 1)), flat(a), flat(m), flat(s), flat(lp),
               flat(old_vnorm), adv, flat(ret_norm)) + agent.extra_dataset(ts, traj, flat)
    params, opt_state, lr = ts.params, ts.opt_state, ts.lr
    grad = jax.jit(jax.grad(agent._loss, has_aux=True))
    auxs = []
    for e in range(cfg.mini_epochs):
        shuffled = [x[perms[e]] for x in dataset]
        for i in range(agent.num_minibatches):
            mb = tuple(x[i * agent.minibatch_size:(i + 1) * agent.minibatch_size] for x in shuffled)
            grads, aux_ = grad(params, mb, value_rms)
            updates, opt_state = agent.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -lr * u, updates))
            lr = agent._update_lr(lr, aux_[4])
            auxs.append([float(x) for x in aux_])
    auxs = np.asarray(auxs)
    metrics = dict(zip(("a_loss", "c_loss", "entropy", "b_loss"), auxs[:, :4].mean(0)))
    metrics.update(kl=auxs[-agent.num_minibatches:, 4].mean(), lr=float(lr), reward_mean_step=float(jnp.mean(
        traj.reward)), disc_reward_mean=float(aux["disc_reward_mean"]))
    ts = ts.replace(params=params, opt_state=opt_state, lr=lr, value_rms=value_rms, env_state=env_state, obs=obs)
    return ts, metrics, np.asarray(dataset[-1])


def test_amp_epoch_matches_jax(agents):
    """One whole AMP epoch (rollout with the AMP windows captured, style
    rewards, GAE, the demo windows and the discriminator in the PPO loss, one
    Adam over both nets with the joint gradient clip) against the JAX
    package with its draws: metrics, the policy's and the discriminator's
    parameters at rtol 2e-4; amp_rms, the moments of the rollout's eight
    windows, within 2e-3 (their dof velocities come out of the float32
    physics, which tests/test_fused.py holds to qd 2e-3), the variance of
    velocities near 5 rad/s at rtol 1e-3 (it squares their rounding)."""
    jagent, tagent = agents
    jts = _jax_init(jagent)
    tts = _port_state_from(tagent, jts)
    rng = np.random.RandomState(7)
    H, B = AMP_TRAIN["config"]["horizon_length"], jagent.batch_size
    noise = rng.normal(size=(H, N, 28)).astype(np.float32)
    perms = np.stack([rng.permutation(B) for _ in range(2)])
    # the JAX dataset holds the raw demo windows, as the port takes them
    jts, want, demos = _jax_amp_epoch(jagent, jts, jnp.asarray(noise), perms)
    tts, got = tagent.train_epoch(tts, noise=torch.tensor(noise), perms=torch.tensor(perms),
                                  demos=torch.tensor(demos))
    for k in ("a_loss", "c_loss", "entropy", "b_loss", "kl", "lr", "reward_mean_step", "disc_reward_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6, err_msg=k)
    jp, tp = _jax_params(jts.params), _port_params(tagent)
    assert set(jp) == set(tp) and any(k.startswith("disc.") for k in tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=2e-4, atol=1e-5, err_msg=k)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tts.amp_rms, f).numpy(), np.asarray(getattr(jts.params["amp_rms"], f)),
                                   rtol=1e-3 if f == "var" else 2e-4, atol=2e-3, err_msg=f)
    assert 0.0 <= got["disc_acc"] <= 1.0


def test_amp_checkpoint_roundtrip(agents, tmp_path):
    """The checkpoint carries the discriminator and amp_rms; a fresh agent
    of another seed restores both and the joint optimizer bit for bit."""
    from isaacgymenvs_tpu_torch.learn import AMPAgent

    tagent = agents[1]
    ts, _ = tagent.train_epoch(tagent.init())
    path = str(tmp_path / "amp.pth")
    tagent.save(path, ts, epoch=1)
    other = AMPAgent(tagent.env, AMP_TRAIN, seed=5)
    ots, epoch = other.restore(path, other.init())
    assert epoch == 1
    for (n, a), (_, b) in zip(tagent.named_trainables(), other.named_trainables(), strict=True):
        assert torch.equal(a, b), n
    assert all(torch.equal(getattr(ts.amp_rms, f), getattr(ots.amp_rms, f)) for f in ("mean", "var", "count"))
    sa, sb = ts.optimizer.state_dict()["state"], ots.optimizer.state_dict()["state"]
    assert set(sa) == set(sb) and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in ("exp_avg", "step"))


@pytest.mark.parametrize("task", ["HumanoidAMP", "Humanoid", "Ant", "Anymal", "Cartpole"])
def test_body_poses_equal_forward_kinematics(task):
    """`BodyPoses` (a tree level at a time, positions and rotations only)
    gives the full forward kinematics' x and quat bit for bit: free, hinge,
    fixed and slide joints."""
    from isaacgymenvs_tpu_torch.engine.dynamics import BodyPoses, forward_kinematics
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    env = task_map[task](load_config([f"task={task}", "num_envs=8"])["task"], device="cpu")
    state, _ = env.reset(1)
    q = state.sim.q + 0.1 * torch.randn(state.sim.q.shape, generator=torch.Generator().manual_seed(2))
    kin = forward_kinematics(env.model, q, state.sim.qd)
    x, quat = BodyPoses(env.model, "cpu")(q)
    assert torch.equal(x, kin.x) and torch.equal(quat, kin.quat)
