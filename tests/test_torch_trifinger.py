"""The port's Trifinger against the JAX package, on the CPU: the
TriFingerPro stand-in, the task's model, the hooks at drawn states in both
command modes, the plain step on the task's contact states, reset and env
steps; and the port's counterparts of tests/test_trifinger.py.

The stand-in is assets/trifinger/robot_properties_fingers/urdf/pro/trifingerpro.urdf;
the JAX package reads it through $ISAACGYMENVS_TPU_ASSETS. Goals are drawn
the JAX way in the tests (one key for a placement's radius and angle) and
handed to the port (`goal_from_draws`). Tolerances: models within 1e-6;
hooks 1e-5; the plain step q 2e-4, qd 2e-3, forces 2e-2
(tests/test_fused.py:79-82) on the envs `torch_conditioning.kept` keeps;
env steps as the plain step, observations 1e-3 (normalized: radians over
ranges of a few), rewards 1e-2 (the finger-motion terms divide tip
displacements by dt and scale by 250 and 0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_conditioning as cond
from isaacgymenvs_tpu_torch.convert import env_state_from_arrays, task_from_arrays
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.model import load_urdf
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from test_torch_anymal import _assert_models_equal

torch.set_num_threads(1)

N = 4
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
URDF = "trifinger/robot_properties_fingers/urdf/pro/trifingerpro.urdf"
_ENVS = {}


@pytest.fixture(autouse=True)
def _jax_assets(monkeypatch):
    monkeypatch.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())




def _both(extra=()):
    """The JAX env and the port's env at N envs (DR off unless `extra` asks), built once per worker."""
    key = tuple(extra)
    if key not in _ENVS:
        from isaacgymenvs_tpu.tasks import task_map as jtasks
        from isaacgymenvs_tpu.utils.config import load_config as jload
        from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
        from isaacgymenvs_tpu_torch.utils.config import load_config as tload

        args = ["task=Trifinger", f"num_envs={N}", "task.task.randomize=False", *extra]
        jcfg = jload(args)["task"]
        jcfg["sim"]["use_fused"] = True
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
            _ENVS[key] = (jtasks["Trifinger"](jcfg), ttasks["Trifinger"](tload(args)["task"], device="cpu"))
    return _ENVS[key]


def test_stand_in_matches_jax():
    """The TriFingerPro stand-in through both URDF parsers (fix_base):
    equal models; 9 revolute dofs in three fingers with the public joint
    names and limits, a finger_tip_link on each; at the task's default pose
    the tips hang just above the table."""
    from isaacgymenvs_tpu.model import load_urdf as jload_urdf
    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics

    path = f"{package_asset_root()}/{URDF}"
    tm, jm = load_urdf(path, fix_base=True), jload_urdf(path, fix_base=True)
    _assert_models_equal(tm, jm)
    assert (tm.nq, tm.nv) == (9, 9)
    names = tm.dof_joint_names()
    assert names == tuple(f"finger_{j}_joint_{d}" for d in (0, 120, 240)
                          for j in ("base_to_upper", "upper_to_middle", "middle_to_lower"))
    np.testing.assert_allclose(tm.dof_limit_lower, np.tile([-0.33, 0.0, -2.7], 3), atol=1e-6)
    np.testing.assert_allclose(tm.dof_limit_upper, np.tile([1.0, 1.57, 0.0], 3), atol=1e-6)
    tips = [i for i, n in enumerate(tm.body_names) if "tip_link" in n]
    assert len(tips) == 3
    q = torch.tensor(np.tile([0.0, 0.9, -2.0], 3), dtype=torch.float32)[None]
    z = forward_kinematics(tm, q, torch.zeros(1, 9)).x[0, tips, 2]
    assert bool(((z > 0.0095) & (z < 0.05)).all()), z


def test_model_matches_jax():
    """The composed scene equals JAX's leaf by leaf: 14 bodies, nv 15; the
    cube's 8 corners and the 3 tips as plane rows, the tips against the
    cube as pair rows; no cap, 4 substeps of 32 APGD iterations."""
    jenv, tenv = _both()
    _assert_models_equal(tenv.model, jenv.model)
    m, p = tenv.model, tenv.sim_params
    s = tfused.spec_of(m)
    assert (m.nbody, m.nq, m.nv, s.nc, s.pp_nc, tfused.topk_cap(s, p)) == (14, 16, 15, 11, 3, 0)
    assert (p.substeps, p.solver_apgd_iterations) == (4, 32) and tfused.fused_supported(m, p)
    for name in ("q_idx", "v_idx", "tip_bodies", "default_dof", "obs_lo", "obs_hi", "action_lo", "action_hi"):
        np.testing.assert_allclose(getattr(tenv, name).numpy(), np.asarray(getattr(jenv, name)), atol=1e-7,
                                   err_msg=name)


def _jax_goal_draws(keys):
    """The JAX goal sampler's draws per key: the placement (N, 2), z's (N,),
    the rotation's (N, 2)."""
    def one(key):
        kxy, kz, kq = jax.random.split(key, 3)
        r = 0.195 * jnp.sqrt(jax.random.uniform(kxy, ()))
        th = jax.random.uniform(kxy, (), minval=-jnp.pi, maxval=jnp.pi)
        return (jnp.stack([r * jnp.cos(th), r * jnp.sin(th)]), jax.random.uniform(kz, ()),
                jax.random.uniform(kq, (2,), minval=-1.0, maxval=1.0))

    return tuple(torch.tensor(np.asarray(a)) for a in jax.vmap(one)(keys))


@pytest.mark.parametrize("difficulty", [1, 2, 3, 4])
def test_goal_difficulties_match_jax(difficulty):
    """`goal_from_draws` on the JAX sampler's draws gives its goals, for
    each difficulty."""
    jenv, tenv = _both((f"task.env.task_difficulty={difficulty}",))
    keys = jax.random.split(jax.random.PRNGKey(difficulty), 8)
    want = jax.vmap(jenv._sample_goal)(keys)
    np.testing.assert_allclose(tenv.goal_from_draws(*_jax_goal_draws(keys)).numpy(), np.asarray(want), atol=1e-6)


def _port_task(jtask):
    return task_from_arrays(jax.tree.map(np.asarray, jtask), "cpu")


@pytest.mark.parametrize("extra", [(), ("task.env.command_mode=position",),
                                   ("task.env.command_mode=position", "task.env.apply_safety_damping=False"),
                                   ("task.env.normalize_action=False", "task.env.normalize_obs=False"),
                                   ("task.env.task_difficulty=3",)])
def test_hooks_match_jax(extra):
    """At states drawn from the JAX reset (joints jittered, random
    velocities, sensors, actions, the last fingertips and cube), in each
    command mode: `compute_force` (the clip, the safety damping and the
    second clip), `observe` (normalized or not), `observe_state` (113: the
    fingertips' states and wrenches, the joints' contact forces),
    `reward_done` (the keypoint kernel, the fingers' motion and reach, the
    success flags) and the extras."""
    from isaacgymenvs_tpu.engine import dynamics as jdyn
    from isaacgymenvs_tpu.envcore.vec_task import Sensors as JSensors
    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics
    from isaacgymenvs_tpu_torch.envcore.vec_task import Sensors

    jenv, tenv = _both(extra)
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    jq, jqd, jtask = jax.vmap(jenv.sample_init)(keys)
    rng = np.random.RandomState(3)
    q = np.asarray(jq) + np.where(np.arange(tenv.model.nq) < 9, rng.uniform(-0.3, 0.3, (N, tenv.model.nq)), 0.0)
    q = q.astype(np.float32)
    qd = rng.uniform(-2, 2, (N, tenv.model.nv)).astype(np.float32)
    nb = tenv.model.nbody
    sens = [rng.normal(size=s).astype(np.float32) for s in ((N, nb, 3), (N, nb, 3), (N, tenv.model.nv))]
    acts = rng.uniform(-1, 1, (N, 9)).astype(np.float32)
    jtask = {**jtask, "last_tips": jnp.asarray(rng.uniform(-0.1, 0.1, (N, 3, 3)).astype(np.float32)),
             "last_obj": jnp.asarray(rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32))}
    # the goal within tolerance in env 0: the success flags
    q[0, tenv.oq:tenv.oq + 7] = np.asarray(jtask["goal"])[0]
    ttask = _port_task(jtask)
    tq, tqd, ta = torch.tensor(q), torch.tensor(qd), torch.tensor(acts)
    qfrc, xfrc = tenv.compute_force(ta, tq, tqd, ttask)
    jqfrc, jxfrc = jax.vmap(jenv.compute_force)(jnp.asarray(acts), jnp.asarray(q), jnp.asarray(qd), jtask)
    np.testing.assert_allclose(qfrc.numpy(), np.asarray(jqfrc), atol=1e-6)
    np.testing.assert_allclose(xfrc.numpy(), np.asarray(jxfrc), atol=0)
    assert float(qfrc.abs().max()) <= 0.36 + 1e-6
    tkin = forward_kinematics(tenv.model, tq, tqd)
    jfk = jax.jit(jax.vmap(lambda a, b: jdyn.forward_kinematics(jenv.model, a, b)))
    jkin = jfk(jnp.asarray(q), jnp.asarray(qd))
    progress = np.asarray([0, 3, tenv.max_episode_length - 1, 7], np.int32)
    args_t = (tq, tqd, tkin, Sensors(*map(torch.tensor, sens)), ttask, ta, torch.tensor(progress))
    args_j = (jnp.asarray(q), jnp.asarray(qd), jkin, JSensors(*map(jnp.asarray, sens)), jtask, jnp.asarray(acts),
              jnp.asarray(progress))
    obs, jobs = tenv.observe(*args_t), jax.vmap(jenv.observe)(*args_j)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5, err_msg="observe")
    st, jst = tenv.observe_state(*args_t), jax.vmap(jenv.observe_state)(*args_j)
    assert st.shape == (N, 113) and obs.shape == (N, 41)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5, rtol=1e-6, err_msg="observe_state")
    rew, done, new = tenv.reward_done(obs, *args_t)
    jrew, jdone, jnew = jax.vmap(jenv.reward_done)(jobs, *args_j)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=1e-5, atol=1e-3, err_msg="reward")
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    for k, v in _port_task(jnew).items():
        np.testing.assert_allclose(new[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    assert float(new["success_pos"][0]) == 1.0
    ex = tenv.extra_outputs(*args_t[:4], new, *args_t[5:])
    jex = jax.vmap(jenv.extra_outputs)(*args_j[:4], jnew, *args_j[5:])
    assert set(ex) == set(jex) and all(np.array_equal(ex[k].numpy(), np.asarray(jex[k])) for k in ex)


def test_plain_step_matches_jax():
    """At the task's `contact_states` (the cube on the table, one fingertip
    in turn pressing a face 0-0.5 mm in), under the safety damping at zero
    actions: the plain step against JAX `physics_step_fused(use_pallas=False)`
    on the envs `torch_conditioning.kept` keeps (q 2e-4, qd 2e-3, forces
    2e-2); the cube carries contact force in every kept env, and a tip in
    some (a tip pressed into a face is pushed out within the step, and the
    step reports its last slice)."""
    from isaacgymenvs_tpu.engine import fused as jfused

    jenv, tenv = _both()
    n = 12
    q, qd = tenv.contact_states(n, seed=5)
    qfrc, xfrc = tenv.compute_force(torch.zeros(n, 9), q, qd, None)
    m, p = tenv.model, tenv.sim_params
    s = tfused.spec_of(m)
    keep = cond.kept(cond.port_gaps(s, p, q, qd, qfrc, xfrc),
                     cond.jax_gaps(jenv.model, jenv.sim_params, q, qd, qfrc, xfrc))
    assert int(keep.sum()) >= n // 2, keep
    tout = tfused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc)
    jout = jfused.physics_step_fused(jenv.model, jenv.sim_params, jnp.asarray(q.numpy()), jnp.asarray(qd.numpy()),
                                     jnp.asarray(qfrc.numpy()), xfrc=jnp.asarray(xfrc.numpy()), use_pallas=False)
    k_ = keep.numpy()
    for k, tol in TOL.items():
        np.testing.assert_allclose(getattr(tout, k).numpy()[k_], np.asarray(getattr(jout, k))[k_], atol=tol,
                                   err_msg=k)
    bf = np.linalg.norm(np.asarray(jout.body_force), axis=-1)[k_]
    assert (bf[:, tenv.obj_ref.body0] > 0.01).all() and (bf[:, tenv.tip_bodies.numpy()] > 1e-3).any()


def _fields(js):
    return {"q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf,
            "actions": js.actions, "task": jax.tree.map(np.asarray, js.task)}


@pytest.mark.parametrize("mode", ["torque", "position"])
def test_reset_and_env_steps_match_jax(mode):
    """The port's observation of the JAX reset state equals the JAX reset's;
    from the port's `contact_states`, put on both, three env steps of random
    actions against the JAX step under `jax.jit`: q, qd, observation, reward, done,
    the task state and the success extras; the asymmetric states."""
    jenv, tenv = _both((f"task.env.command_mode={mode}",))
    jstate, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tstate = env_state_from_arrays(tenv.reset(0)[0], _fields(jstate), "cpu")
    kin = tenv._kin(tstate.sim.q, tstate.sim.qd)
    obs = tenv.observe(tstate.sim.q, tstate.sim.qd, kin, tenv._no_sensors(N), tstate.task, tstate.actions,
                       tstate.progress)
    np.testing.assert_allclose(torch.clamp(obs, -tenv.clip_obs, tenv.clip_obs).numpy(), np.asarray(jobs), atol=1e-5)
    q, qd = tenv.contact_states(N, seed=9)
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q.numpy()), qd=jnp.asarray(qd.numpy())))
    tstate = env_state_from_arrays(tstate, _fields(jstate), "cpu")
    step = jax.jit(jenv.step)
    rng = np.random.RandomState(10)
    for k in range(3):
        a = rng.uniform(-0.5, 0.5, (N, 9)).astype(np.float32)
        jstate, jobs, jrew, jdone, jex = step(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        np.testing.assert_allclose(tstate.sim.q.numpy(), np.asarray(jstate.sim.q), atol=TOL["q"], err_msg=f"q {k}")
        np.testing.assert_allclose(tstate.sim.qd.numpy(), np.asarray(jstate.sim.qd), atol=TOL["qd"],
                                   err_msg=f"qd {k}")
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-3, err_msg=f"obs {k}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-2, err_msg=f"reward {k}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(tex["states"].numpy(), np.asarray(jex["states"]), atol=2e-2, err_msg="states")
        for name in ("successes", "successes_pos", "successes_quat", "time_outs"):
            np.testing.assert_array_equal(tex[name].numpy(), np.asarray(jex[name]), err_msg=name)
        for name in ("goal", "last_tips", "last_obj"):
            np.testing.assert_allclose(tstate.task[name].numpy(), np.asarray(jstate.task[name]), atol=2e-4,
                                       err_msg=name)


def test_randomized_yaml_steps():
    """Trifinger.yaml's own randomization block (on by default): the per-env
    leaves the physics takes (the cube's mass, scale and friction, the joint
    limits) and gravity, actuator and observation noise; the env steps with
    them, finite."""
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    env = task_map["Trifinger"](load_config(["task=Trifinger", "num_envs=4"])["task"], device="cpu")
    assert env.randomizer is not None
    state, obs = env.reset(0)
    assert set(state.dyn.names) == {"dof_limit_lower", "dof_limit_upper", "body_mass", "cpoint_friction", "body_ipos",
                                    "body_inertia", "cpoint_pos", "geom_size", "gravity"}
    for _ in range(3):
        state, obs, rew, done, ex = env.step(state, torch.zeros(4, 9))
    assert bool(torch.isfinite(state.sim.q).all() & torch.isfinite(obs).all())


# ---- tests/test_trifinger.py, the port's counterparts ---------------------------

def _make(n=2, **env_kw):
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config(["task=Trifinger", f"num_envs={n}", "task.task.randomize=False"])["task"]
    cfg["env"].update(env_kw)
    return task_map["Trifinger"](cfg, device="cpu")


def test_spec_dims_and_normalized_obs():
    env = _make()
    assert env.num_obs == sum(env.OBS_SPEC.values()) == 41
    assert env.num_states == 41 + sum(env.STATE_EXTRA_SPEC.values()) == 113
    state, obs = env.reset(0)
    for _ in range(5):
        state, obs, rew, done, ex = env.step(state, torch.zeros(2, 9))
    assert bool((obs[:, :9].abs() <= 1.01).all()) and bool((obs[:, 18:32].abs() <= 1.5).all())
    assert {"successes", "successes_pos", "successes_quat"} <= set(ex)


def test_position_command_mode_tracks_targets():
    """The position mode PD-tracks the default pose far better than
    uncontrolled joints under gravity (the upper and middle joints)."""
    def error(command_mode, act):
        env = _make(command_mode=command_mode, apply_safety_damping=False)
        state, obs = env.reset(1)
        a = (2.0 * (env.default_dof - env.action_lo) / (env.action_hi - env.action_lo) - 1.0).expand(2, 9) \
            if act == "default" else torch.zeros(2, 9)
        for _ in range(40):
            state, obs, rew, done, ex = env.step(state, a)
        qj = state.sim.q[:, env.q_idx]
        return float((qj - env.default_dof).abs()[:, [0, 1, 3, 4, 6, 7]].mean())

    tracked, free = error("position", "default"), error("torque", "zero")
    assert tracked < 0.2 and tracked < free * 0.5, (tracked, free)


def test_safety_damping_slows_joints():
    """With the safety damping the joints bleed velocity faster under zero
    torque commands. Over 3 steps (0.06 s): the JAX test's 10 take the
    stand-in's joints at 5 rad/s into their limits, whose springs stop them
    with or without the damping."""
    def peak_speed(safety):
        env = _make(apply_safety_damping=safety)
        state, obs = env.reset(2)
        state.sim.qd[:, env.v_idx] = 5.0
        for _ in range(3):
            state, obs, rew, done, ex = env.step(state, torch.zeros(2, 9))
        return float(state.sim.qd[:, env.v_idx].abs().max())

    assert peak_speed(True) < peak_speed(False) - 0.2


def test_obs_spec_dict_view():
    """The per-component observation dict through the dict-observation API."""
    env = _make()
    assert env.observation_dict_space == dict(env.OBS_SPEC)
    state, obs = env.reset(1)
    d = env.obs_dict(obs)
    assert set(d) == set(env.OBS_SPEC) and all(tuple(d[k].shape) == (2, n) for k, n in env.OBS_SPEC.items())
    state, d, rew, done, ex = env.step_dict(state, torch.zeros(2, 9))
    assert set(d) == set(env.OBS_SPEC) and torch.cat([d[k] for k in env.OBS_SPEC], -1).shape == (2, 41)
