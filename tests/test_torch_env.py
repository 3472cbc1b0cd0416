"""The port's Ant and Cartpole VecTasks against the JAX env step, from the
same state.

The JAX step runs op by op (not under jit) with its fused physics math:
under jit XLA fuses the reward and rounds the ~6e4-sized potentials
differently (up to 2e-2 in the reward of the same inputs), while op by op
it rounds as the port does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

N = 4
CFG = {"env": {"numEnvs": N, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}


@pytest.fixture(scope="module")
def envs():
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Ant"]({"env": dict(CFG["env"]), "sim": {**CFG["sim"], "use_fused": True}})
        tenv = ttasks["Ant"]({k: dict(v) for k, v in CFG.items()}, device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    return jenv, tenv, jstate, jenv.step


def port_state_from(tenv, jstate):
    """A port EnvState holding the JAX state's contents."""
    st, _ = tenv.reset(0)
    t = lambda a: torch.tensor(np.asarray(a))
    st.sim = SimState(q=t(jstate.sim.q), qd=t(jstate.sim.qd))
    st.progress = t(jstate.progress).to(torch.int32)
    st.reset_buf = t(jstate.reset_buf)
    st.actions = t(jstate.actions)
    st.task = tuple(t(x) for x in jstate.task)
    return st


def actions(seed):
    return np.random.RandomState(seed).uniform(-1.2, 1.2, (N, 8)).astype(np.float32)


def test_step_matches_jax(envs):
    jenv, tenv, jstate, jstep = envs
    tstate = port_state_from(tenv, jstate)
    for k in range(3):
        a = actions(k)
        jstate, jobs, jrew, jdone, jex = jstep(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-3)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-3)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tex["time_outs"].numpy(), np.asarray(jex["time_outs"]))
        assert tobs.shape == (N, tenv.num_obs) and tobs.dtype == torch.float32


def test_time_outs(envs):
    jenv, tenv, jstate, jstep = envs
    # env 0 and 1 reach the episode end on this step, 2 and 3 do not
    prog = np.array([998, 998, 10, 10], np.int32)
    jstate = jstate.replace(progress=jnp.asarray(prog))
    tstate = port_state_from(tenv, jstate)
    a = actions(7)
    jstate, _, _, jdone, jex = jstep(jstate, jnp.asarray(a))
    tstate, _, _, tdone, tex = tenv.step(tstate, torch.tensor(a))
    assert tenv.max_episode_length == 1000
    np.testing.assert_array_equal(tdone.numpy(), [True, True, False, False])
    np.testing.assert_array_equal(tex["time_outs"].numpy(), [True, True, False, False])
    np.testing.assert_array_equal(tex["time_outs"].numpy(), np.asarray(jex["time_outs"]))
    np.testing.assert_array_equal(tstate.progress.numpy(), [999, 999, 11, 11])


def test_partial_reset(envs):
    _, tenv, jstate, _ = envs
    base = port_state_from(tenv, jstate)
    base.progress = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    flagged = port_state_from(tenv, jstate)
    flagged.progress = base.progress.clone()
    flagged.reset_buf = torch.tensor([True, False, True, False])
    a = torch.tensor(actions(3))
    s0, obs0, _, _, _ = tenv.step(base, a)
    s1, obs1, _, _, _ = tenv.step(flagged, a)
    keep = torch.tensor([1, 3])
    # envs not reset: exactly the step without resets
    assert torch.equal(s1.sim.q[keep], s0.sim.q[keep])
    assert torch.equal(s1.sim.qd[keep], s0.sim.qd[keep])
    assert torch.equal(obs1[keep], obs0[keep])
    np.testing.assert_array_equal(s1.progress.numpy(), [0, 7, 0, 9])
    # reset envs: a fresh sample_init state
    reset = torch.tensor([0, 2])
    q, qd = s1.sim.q[reset], s1.sim.qd[reset]
    assert torch.all(q[:, 2] == tenv.start_height)
    dof_pos = q[:, tenv.dof_q_idx]
    lo = torch.clamp(tenv.initial_dof_pos - 0.2, tenv.dof_lower, tenv.dof_upper)
    hi = torch.clamp(tenv.initial_dof_pos + 0.2, tenv.dof_lower, tenv.dof_upper)
    assert torch.all(dof_pos >= lo - 1e-6) and torch.all(dof_pos <= hi + 1e-6)
    dof_vel = qd[:, tenv.dof_idx]
    assert torch.all(dof_vel.abs() <= 0.1)
    assert torch.all(qd[:, :6] == 0)
    assert torch.all(obs1[reset, 28:52] == 0)  # sensors of reset envs are zero


# ---- Cartpole ---------------------------------------------------------------

CP_CFG = {"env": {"numEnvs": N, "clipObservations": 5.0, "clipActions": 1.0},
          "sim": {"dt": 0.0166, "substeps": 2}}


@pytest.fixture(scope="module")
def cartpoles():
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Cartpole"]({"env": dict(CP_CFG["env"]), "sim": {**CP_CFG["sim"], "use_fused": True}})
        tenv = ttasks["Cartpole"]({k: dict(v) for k, v in CP_CFG.items()}, device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(1))
    return jenv, tenv, jstate


def test_cartpole_step_matches_jax(cartpoles):
    """Obs, reward, done and time-outs over four steps, atol 1e-4 (float32
    physics of a 2-dof chain; the port and the JAX step share the math)."""
    jenv, tenv, jstate = cartpoles
    assert tenv.num_obs == 4 and tenv.num_acts == 1 and tenv.max_episode_length == 500
    assert tenv.clip_obs == 5.0 and tenv.model.body_pos[0, 2] == 2.0
    # env 3 starts with its pole beyond pi/2: it dies on the first step
    q = np.asarray(jstate.sim.q).copy()
    q[3, 1] = 1.7
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q)))
    tstate = port_state_from(tenv, jstate)
    rng = np.random.RandomState(11)
    for k in range(4):
        a = rng.uniform(-1.2, 1.2, (N, 1)).astype(np.float32)
        jstate, jobs, jrew, jdone, jex = jenv.step(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        if k == 0:
            assert bool(tdone[3]) and float(trew[3]) == -2.0 and not bool(tex["time_outs"][3])
            # from here the reset draws differ (each package has its own generator)
            keep = [0, 1, 2]
        np.testing.assert_allclose(tobs.numpy()[keep], np.asarray(jobs)[keep], atol=1e-4)
        np.testing.assert_allclose(trew.numpy()[keep], np.asarray(jrew)[keep], atol=1e-4)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tex["time_outs"].numpy(), np.asarray(jex["time_outs"]))


def test_cartpole_time_outs_and_reset(cartpoles):
    jenv, tenv, jstate = cartpoles
    jstate = jstate.replace(progress=jnp.asarray(np.array([498, 498, 3, 3], np.int32)))
    tstate = port_state_from(tenv, jstate)
    a = np.zeros((N, 1), np.float32)
    jstate, _, _, jdone, jex = jenv.step(jstate, jnp.asarray(a))
    tstate, _, _, tdone, tex = tenv.step(tstate, torch.tensor(a))
    np.testing.assert_array_equal(tdone.numpy(), [True, True, False, False])
    np.testing.assert_array_equal(tex["time_outs"].numpy(), np.asarray(jex["time_outs"]))
    np.testing.assert_array_equal(tex["time_outs"].numpy(), [True, True, False, False])
    # the next step resets envs 0 and 1 to a fresh sample_init state
    tstate, obs, _, _, _ = tenv.step(tstate, torch.tensor(a))
    np.testing.assert_array_equal(tstate.progress.numpy(), [0, 0, 5, 5])
    assert torch.all(tstate.sim.q[:2].abs() <= 0.1) and torch.all(tstate.sim.qd[:2].abs() <= 0.25)
    assert tstate.task == ()


# ---- the procedural-model tasks: Ingenuity, Quadcopter, BallBalance ----------

PROCEDURAL = ["Ingenuity", "Quadcopter", "BallBalance"]


def _jax_fields(m):
    import dataclasses

    return {f.name: (np.asarray(getattr(m, f.name)) if hasattr(getattr(m, f.name), "shape")
                     else getattr(m, f.name)) for f in dataclasses.fields(m)}


@pytest.fixture(scope="module", params=PROCEDURAL)
def procedural(request):
    """(name, JAX env, port env, JAX state) at 4 envs from each package's
    own yaml; the JAX env steps through its fused math."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    name = request.param
    args = [f"task={name}", f"num_envs={N}"]
    jcfg = jload(args)["task"]
    jcfg["sim"]["use_fused"] = True
    jenv = jtasks[name](jcfg)
    tenv = ttasks[name](tload(args)["task"], device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(2))
    return name, jenv, tenv, jstate


def _procedural_state(name, tenv, jstate):
    """The port's EnvState with the JAX state's contents. Ingenuity's task
    differs by declaration: the JAX PRNG key has no counterpart, the port's
    own list of episode targets stays."""
    st, _ = tenv.reset(0)
    t = lambda a: torch.tensor(np.asarray(a))
    st.sim = SimState(q=t(jstate.sim.q), qd=t(jstate.sim.qd))
    st.progress = t(jstate.progress).to(torch.int32)
    st.reset_buf = t(jstate.reset_buf)
    st.actions = t(jstate.actions)
    if name == "Ingenuity":
        st.task = (t(jstate.task[0]), st.task[1])
    elif name == "Quadcopter":
        st.task = tuple(t(x) for x in jstate.task)
    else:
        st.task = t(jstate.task)
    return st


def _task_arrays(name, task):
    if name == "Ingenuity":
        return [task[0]]
    return list(task) if name == "Quadcopter" else [task]


def _start(name, jenv, jstate):
    """A start state that makes the step's branches run: BallBalance with
    the ball resting on the tray in envs 0 and 1 (tray force sensors read
    its weight), every task with env 3 about to die."""
    q = np.asarray(jstate.sim.q).copy()
    qd = np.asarray(jstate.sim.qd).copy()
    if name == "BallBalance":
        bq, bv = jenv.ball_q, jenv.model.v_adr[jenv.ball_body]
        for e, xy in ((0, (0.05, -0.1)), (1, (-0.15, 0.1))):
            q[e, bq:bq + 3] = (*xy, jenv.tray_height + 0.01 + jenv.ball_radius - 0.004)
            qd[e, bv:bv + 3] = 0.0
        q[3, bq + 2] = 0.1  # below 1.5 radii: done
    else:
        q[3, 2] = 0.2  # below the height floor of both copters: done
    return jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q), qd=jnp.asarray(qd)))


def test_procedural_model_matches_jax(procedural):
    """`build_model` of the port equals the JAX task's model carried through
    `convert.model_from_arrays`, field by field (floats to 1e-6)."""
    import dataclasses

    from isaacgymenvs_tpu_torch.convert import model_from_arrays

    name, jenv, tenv, _ = procedural
    carried = model_from_arrays(_jax_fields(jenv.model))
    for f in dataclasses.fields(tenv.model):
        a, b = getattr(tenv.model, f.name), getattr(carried, f.name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, f.name
    if name == "BallBalance":
        m = tenv.model
        assert m.ppair_point == (m.cpoint_body.index(tenv.ball_body),) and len(m.att_body) == 3
        assert isinstance(carried.ppair_point, tuple) and isinstance(carried.att_body, tuple)
        assert carried.att_offset.dtype == np.float32 and carried.att_target.shape == (3, 3)
    jp, tp = jenv.sim_params, tenv.sim_params
    for f in ("dt", "substeps", "solver_apgd_iterations", "contact_margin", "baumgarte_erp_attractor",
              "max_depenetration_velocity", "max_active_contacts"):
        assert getattr(jp, f) == pytest.approx(getattr(tp, f)), f
    np.testing.assert_allclose(np.asarray(jp.gravity), tp.gravity)


def test_procedural_step_matches_jax(procedural):
    """reset + 4 steps against the JAX env (its step under `jax.jit`) from the same
    injected state and actions: obs and reward atol 2e-3 (BallBalance's obs
    carry contact forces / 20), done, time-outs and the integrated targets
    in `task`. Env 3 dies on the first step; from then on its reset draws
    differ (each package has its own generator)."""
    name, jenv, tenv, jstate = procedural
    jstate = _start(name, jenv, jstate)
    tstate = _procedural_state(name, tenv, jstate)
    rng = np.random.RandomState(5)
    keep = [0, 1, 2, 3]
    tray_fz = np.zeros(N)
    jstep = jax.jit(jenv.step)
    for k in range(4):
        a = rng.uniform(-1.2, 1.2, (N, tenv.num_acts)).astype(np.float32)
        if name == "BallBalance":
            a[:2] *= 0.1  # gentle: a tray that drops away would leave its ball in free fall
        jstate, jobs, jrew, jdone, jex = jstep(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        assert tobs.shape == (N, tenv.num_obs) and tobs.dtype == torch.float32
        if name == "BallBalance":
            tray_fz = np.maximum(tray_fz, np.abs(tobs.numpy()[:, 14]) * 20.0)
        np.testing.assert_allclose(tobs.numpy()[keep], np.asarray(jobs)[keep], atol=2e-3)
        np.testing.assert_allclose(trew.numpy()[keep], np.asarray(jrew)[keep], atol=2e-3)
        np.testing.assert_array_equal(tdone.numpy()[keep], np.asarray(jdone)[keep])
        np.testing.assert_array_equal(tex["time_outs"].numpy()[keep], np.asarray(jex["time_outs"])[keep])
        for ta, ja in zip(_task_arrays(name, tstate.task), _task_arrays(name, jstate.task)):
            np.testing.assert_allclose(ta.numpy()[keep], np.asarray(ja)[keep], atol=1e-5)
        if k == 0:
            assert bool(tdone[3]) and not bool(tex["time_outs"][3])
            keep = [0, 1, 2]
    if name == "BallBalance":
        # the ball presses on the tray in envs 0 and 1 (newtons), nowhere else
        assert np.all(tray_fz[:2] > 1.0) and tray_fz[2] == 0.0
    if name != "Ingenuity":
        assert float(torch.abs(_task_arrays(name, tstate.task)[0]).max()) > 0.0  # the targets were integrated


def test_procedural_partial_reset(procedural):
    """Envs flagged done last step restart from `sample_init`; the others
    take exactly the step they would have taken, and match the JAX env."""
    name, jenv, tenv, jstate = procedural
    prog = np.array([5, 6, 7, 8], np.int32)
    flags = np.array([True, False, True, False])
    jflagged = jstate.replace(progress=jnp.asarray(prog), reset_buf=jnp.asarray(flags))
    base = _procedural_state(name, tenv, jstate.replace(progress=jnp.asarray(prog)))
    flagged = _procedural_state(name, tenv, jflagged)
    a = np.random.RandomState(9).uniform(-1, 1, (N, tenv.num_acts)).astype(np.float32)
    s0, obs0, _, _, _ = tenv.step(base, torch.tensor(a))
    s1, obs1, rew1, _, _ = tenv.step(flagged, torch.tensor(a))
    jstate1, jobs, jrew, _, _ = jenv.step(jflagged, jnp.asarray(a))
    keep = torch.tensor([1, 3])
    assert torch.equal(s1.sim.q[keep], s0.sim.q[keep]) and torch.equal(s1.sim.qd[keep], s0.sim.qd[keep])
    assert torch.equal(obs1[keep], obs0[keep])
    np.testing.assert_allclose(obs1.numpy()[keep], np.asarray(jobs)[keep], atol=2e-3)
    np.testing.assert_allclose(rew1.numpy()[keep], np.asarray(jrew)[keep], atol=2e-3)
    np.testing.assert_array_equal(s1.progress.numpy(), [0, 7, 0, 9])
    np.testing.assert_array_equal(s1.progress.numpy(), np.asarray(jstate1.progress))
    # reset envs: a fresh sample_init state inside the task's ranges
    reset = torch.tensor([0, 2])
    q, qd = s1.sim.q[reset], s1.sim.qd[reset]
    if name == "BallBalance":
        bq, bv = tenv.ball_q, tenv.ball_v
        assert torch.all((q[:, bq + 2] >= 1.0) & (q[:, bq + 2] <= 2.0)) and torch.all(qd[:, bv + 2] == -5.0)
        assert torch.all(torch.linalg.vector_norm(q[:, bq:bq + 2], dim=-1) <= 0.5)
        assert torch.all(obs1[reset, 12:24] == 0)  # sensors of reset envs are zero
        # reward_done integrates this step's action onto the fresh zero targets
        fresh = tenv._integrate_targets(torch.zeros(2, 6), torch.tensor(a)[reset])
        assert torch.equal(s1.task[reset], fresh)
    else:
        assert torch.all(qd == 0) and torch.all((q[:, 2] >= 0.8) & (q[:, 2] <= 2.5))
        assert torch.all(q[:, :2].abs() <= 1.5)
    if name == "Quadcopter":
        assert torch.all(q[:, tenv.dof_q_idx].abs() <= 0.2)
        assert torch.all(s1.task[1][reset] == torch.clamp(0.01 * 200.0 * torch.tensor(a)[reset, 8:12], 0.0, 2.0))


def test_ingenuity_target_moves_every_500_steps():
    """The target steps to the episode's next pre-drawn one when progress
    reaches a multiple of 500, and only then."""
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    env = ttasks["Ingenuity"](tload(["task=Ingenuity", f"num_envs={N}"])["task"], device="cpu")
    st, _ = env.reset(3)
    assert env.max_episode_length == 2000 and env.num_targets == 4
    target, targets = st.task
    assert targets.shape == (N, 4, 3) and torch.equal(target, targets[:, 0])
    assert torch.all((targets[..., :2].abs() <= 5.0)) and torch.all((targets[..., 2] >= 1.0) & (targets[..., 2] <= 2.0))
    st.progress = torch.tensor([498, 499, 999, 1499], dtype=torch.int32)
    st, _, _, _, _ = env.step(st, torch.zeros(N, 6))
    np.testing.assert_array_equal(st.progress.numpy(), [499, 500, 1000, 1500])
    assert torch.equal(st.task[0][0], targets[0, 0])
    for e, w in ((1, 1), (2, 2), (3, 3)):
        assert torch.equal(st.task[0][e], targets[e, w])


# ---- Ant with domain randomization ---------------------------------------------


def _ant_dr_envs(frequency):
    """The JAX Ant and the port's with Ant.yaml's randomization block (its
    observation and action noise taken out: the two packages' noise streams
    differ), `frequency` as given; the JAX env steps through its fused math."""
    import copy

    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    params = copy.deepcopy(tload(["task=Ant"])["task"]["task"]["randomization_params"])
    assert params["frequency"] == 600 and params["actor_params"]["ant"]["rigid_body_properties"]["mass"]["setup_only"]
    del params["observations"], params["actions"]
    params["frequency"] = frequency
    task = {"randomize": True, "randomization_params": params}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Ant"]({"env": dict(CFG["env"]), "sim": {**CFG["sim"], "use_fused": True},
                              "task": copy.deepcopy(task)})
        tenv = ttasks["Ant"]({"env": dict(CFG["env"]), "sim": dict(CFG["sim"]), "task": copy.deepcopy(task)},
                             device="cpu")
    return jenv, tenv


def _port_dr_state(tenv, jstate):
    """`port_state_from` plus the JAX state's DR sample and counters."""
    from isaacgymenvs_tpu_torch.convert import dr_sample_from_jax

    st = port_state_from(tenv, jstate)
    st.dr = dr_sample_from_jax({k: np.asarray(v) for k, v in jstate.dr.items()})
    st.dyn = tenv.pack_dyn(st.dr)
    st.randomize_buf = torch.tensor(np.asarray(jstate.randomize_buf)).to(torch.int32)
    st.frames = torch.tensor(np.asarray(jstate.frames)).to(torch.int32)
    return st


def test_ant_randomized_step_matches_jax():
    """Ant with `task.randomize=True` (per-env mass, damping, stiffness and
    both limits) against the JAX env run op by op, four steps from the same
    state with the JAX package's DR sample on the port's state. Env 2 is
    flagged done, so it resets on the first step (its fresh state is each
    package's own draw: it is left out from there). obs and reward atol
    1e-3, q 2e-4, qd 2e-3, done and the DR counters equal."""
    jenv, tenv = _ant_dr_envs(600)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    assert jenv.randomizer.batched_leaf_names() == tenv.randomizer.batched_leaf_names()
    jstate = jstate.replace(reset_buf=jnp.asarray(np.array([False, False, True, False])),
                            progress=jnp.asarray(np.array([5, 6, 7, 8], np.int32)))
    tstate = _port_dr_state(tenv, jstate)
    assert tstate.dyn.names == ("dof_damping", "dof_stiffness", "dof_limit_lower", "dof_limit_upper", "body_mass")
    bare, _ = tenv.reset(0)  # the same sim state stepped without the sample's leaves
    bare.sim = SimState(q=tstate.sim.q.clone(), qd=tstate.sim.qd.clone())
    bare.dr = tenv.randomizer.identity_sample(N)
    bare.dyn = tenv.pack_dyn(bare.dr)
    keep = [0, 1, 3]
    for k in range(4):
        a = actions(20 + k)
        jstate, jobs, jrew, jdone, jex = jenv.step(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        if k == 0:
            bare, _, _, _, _ = tenv.step(bare, torch.tensor(a))
            assert float((bare.sim.qd[keep] - tstate.sim.qd[keep]).abs().max()) > 1e-2  # the leaves act
        np.testing.assert_allclose(tobs.numpy()[keep], np.asarray(jobs)[keep], atol=1e-3)
        np.testing.assert_allclose(trew.numpy()[keep], np.asarray(jrew)[keep], atol=1e-3)
        np.testing.assert_allclose(tstate.sim.q.numpy()[keep], np.asarray(jstate.sim.q)[keep], atol=2e-4)
        np.testing.assert_allclose(tstate.sim.qd.numpy()[keep], np.asarray(jstate.sim.qd)[keep], atol=2e-3)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tex["time_outs"].numpy(), np.asarray(jex["time_outs"]))
        np.testing.assert_array_equal(tstate.progress.numpy(), np.asarray(jstate.progress))
        np.testing.assert_array_equal(tstate.randomize_buf.numpy(), np.asarray(jstate.randomize_buf))
        assert int(tstate.frames) == int(jstate.frames) == k + 1
    assert tstate.progress.tolist() == [9, 10, 3, 12] and tstate.randomize_buf.tolist() == [4, 4, 4, 4]
    for name, v in tstate.dr.items():  # nothing was due: the sample is the injected one
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstate.dr[name]))


def test_ant_rerandomization_bookkeeping_matches_jax():
    """`frequency: 1`: an env that resets takes a fresh sample, except for the
    `setup_only` mass. Both packages are handed the same fresh samples (their
    randomizers' `sample` replaced by a queue of samples the JAX randomizer
    drew beforehand), so `due`, `randomize_buf`, `frames`, the whole sample
    and the port's packed rows can be held against the JAX state step by step."""
    from isaacgymenvs_tpu_torch.convert import dr_sample_from_jax

    jenv, tenv = _ant_dr_envs(1)
    draw = jenv.randomizer.sample
    queue = [{k: np.asarray(v) for k, v in draw(jax.random.PRNGKey(40 + i), N, jnp.zeros((), jnp.int32)).items()}
             for i in range(5)]
    jq, tq = iter(queue), iter([queue[0]] + queue)  # the port resets twice below
    jenv.randomizer.sample = lambda *a, **kw: {k: jnp.asarray(v) for k, v in next(jq).items()}
    tenv.randomizer.sample = lambda *a, **kw: dr_sample_from_jax(next(tq))
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    tstate0, _ = tenv.reset(0)
    mass = "ant.rigid_body_properties.mass"
    damp = "ant.dof_properties.damping"
    np.testing.assert_array_equal(tstate0.dr[mass].numpy(), queue[0][mass])  # reset drew the first sample
    flags = [[True, False, True, False], None, [False, True, False, False], None]
    tstate = _port_dr_state(tenv, jstate)
    want_rbuf = [[0, 1, 0, 1], [1, 2, 1, 2], [2, 0, 2, 3], [3, 1, 3, 4]]
    for k in range(4):
        if flags[k] is not None:
            jstate = jstate.replace(reset_buf=jnp.asarray(np.array(flags[k])))
            tstate.reset_buf = torch.tensor(flags[k])
        a = actions(30 + k)
        jstate, _, _, jdone, _ = jenv.step(jstate, jnp.asarray(a))
        tstate, _, _, tdone, _ = tenv.step(tstate, torch.tensor(a))
        assert not bool(tdone.any()) and not bool(np.asarray(jdone).any())
        assert tstate.randomize_buf.tolist() == want_rbuf[k] == np.asarray(jstate.randomize_buf).tolist()
        assert int(tstate.frames) == int(jstate.frames) == k + 1
        assert set(tstate.dr) == set(jstate.dr)
        for name, v in tstate.dr.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jstate.dr[name]), err_msg=name)
        np.testing.assert_array_equal(tstate.dr[mass].numpy(), queue[0][mass])  # setup_only: the first draw stays
        repacked = tenv.pack_dyn(tstate.dr)
        assert torch.equal(tstate.dyn.rows, repacked.rows) and tstate.dyn.names == repacked.names
    # who holds which draw: envs 0 and 2 took step 1's sample, env 1 step 3's, env 3 still the first
    for env_i, src in ((0, 1), (2, 1), (1, 3), (3, 0)):
        np.testing.assert_array_equal(tstate.dr[damp].numpy()[env_i], queue[src][damp][env_i])
