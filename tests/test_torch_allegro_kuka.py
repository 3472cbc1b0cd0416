"""The port's AllegroKuka family against the JAX package, on the CPU: the
Kuka + Allegro stand-in, the five tasks' models, the hooks at drawn states
(the resets with JAX's draws, `compute_force`, `observe`, `reward_done`
with JAX's goal draws, the tolerance curriculum, Regrasping's carry, the
reset from a state bank), the one-arm plain step on the task's contact
states, reset and env steps, the env-subtask config group and the
resolvers, the yaml's domain randomization; and the port's counterparts of
tests/test_allegro_kuka.py and of
tests/test_ppo.py::test_allegro_kuka_emits_episode_cumulative. The
two-arm model's steps and the counterparts of
tests/test_allegro_kuka_two_arms.py are in
tests/test_torch_allegro_kuka_two_arms.py.

The stand-in is assets/urdf/kuka_allegro_description/kuka_allegro_touch_sensor.urdf;
the JAX package reads it through $ISAACGYMENVS_TPU_ASSETS. The JAX task
draws its resets and new goals from PRNG keys, the port from its
generator: the tests hand the port JAX's draws (`init_from_draws`,
`draws_of_step`). Tolerances: models within 1e-6; hooks 1e-5 (rewards
1e-3: the terms scale distances by 50-1000); the plain step q 2e-4, qd
2e-3, forces 2e-2 (tests/test_fused.py:79-82) on the envs
`torch_conditioning.kept` keeps; env steps as the plain step,
observations 2e-3 (they hold the joints' velocities unscaled, whose
tolerance is qd's) and rewards 1e-3.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_conditioning as cond
from isaacgymenvs_tpu_torch.convert import dr_sample_from_jax, env_state_from_arrays, task_from_arrays
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.model import load_urdf
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from test_torch_anymal import _assert_models_equal

torch.set_num_threads(1)

N = 4
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
URDF = "urdf/kuka_allegro_description/kuka_allegro_touch_sensor.urdf"
TASKS = ["AllegroKukaReorientation", "AllegroKukaRegrasping", "AllegroKukaThrow", "AllegroKukaTwoArmsReorientation",
         "AllegroKukaTwoArmsRegrasping"]
_ENVS = {}


@pytest.fixture(autouse=True)
def _jax_assets(monkeypatch):
    monkeypatch.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())


def both(task, extra=()):
    """The JAX env (its step through the fused math, `sim.use_fused`) and
    the port's env of `task` (a yaml name) at N envs, built once per worker."""
    key = (task, tuple(extra))
    if key not in _ENVS:
        from isaacgymenvs_tpu.tasks import task_map as jtasks
        from isaacgymenvs_tpu.utils.config import load_config as jload
        from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
        from isaacgymenvs_tpu_torch.utils.config import load_config as tload

        args = [f"task={task}", f"num_envs={N}", *extra]
        jcfg = jload(args)["task"]
        jcfg["sim"]["use_fused"] = True
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
            jenv = jtasks[jcfg["name"]](jcfg)
            _ENVS[key] = (jenv, ttasks[jcfg["name"]](tload(args)["task"], device="cpu"))
    return _ENVS[key]


def jax_goal_draws(jenv, kg):
    """The draws JAX `_sample_goal(kg)` takes: pos_u (3,), rot_u (2,), side_u ()."""
    if getattr(jenv, "NUM_ARMS", 1) == 2:
        kp, kr, ks = jax.random.split(kg, 3)
        side = jax.random.uniform(ks)
    else:
        kp, kr = jax.random.split(kg)
        side = jnp.zeros(())
    return jax.random.uniform(kp, (3,)), jax.random.uniform(kr, (2,), minval=-1.0, maxval=1.0), side


def jax_init_draws(jenv, keys, nbank: int = 0):
    """The draws of JAX `_init_with_tolerance` for each key, as the port's
    `init_draws` returns them (the bank rows None without a bank)."""
    nd = 23 * getattr(jenv, "NUM_ARMS", 1)

    def one(k):
        kd, kv, ko, ky, kg, _ = jax.random.split(k, 6)
        u = lambda kk, n: jax.random.uniform(kk, (n,), minval=-1.0, maxval=1.0)
        row = jax.random.randint(jax.random.fold_in(kd, 1), (), 0, max(nbank, 1))
        return (u(kd, nd), u(kv, nd), u(ko, 2), jax.random.uniform(ky, (), minval=-jnp.pi, maxval=jnp.pi),
                jax_goal_draws(jenv, kg), row)

    d = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jax.vmap(one)(keys))
    return (*d[:5], d[5] if nbank else None)


def jax_step_draws(jenv, jtask):
    """The goal draws the JAX reward_done takes from each env's task key."""
    d = jax.vmap(lambda k: jax_goal_draws(jenv, jax.random.split(k)[1]))(jtask["key"])
    return tuple(torch.tensor(np.asarray(a)) for a in d)


def port_task(jtask):
    return task_from_arrays(jax.tree.map(np.asarray, jtask), "cpu")


def assert_task_equal(got, want, atol=1e-5):
    for k, v in port_task(want).items():
        if k == "rew_terms":
            assert set(got[k]) == set(v)
            for kk in v:
                np.testing.assert_allclose(got[k][kk].numpy().astype(np.float64), v[kk].numpy().astype(np.float64),
                                           atol=1e-3, rtol=1e-5, err_msg=kk)
        else:
            np.testing.assert_allclose(got[k].numpy().astype(np.float64), v.numpy().astype(np.float64), atol=atol,
                                       err_msg=k)


def jax_fk(jm, q, qd):
    from isaacgymenvs_tpu.engine import dynamics as jdyn

    return jax.jit(jax.vmap(lambda a, b: jdyn.forward_kinematics(jm, a, b)))(jnp.asarray(q), jnp.asarray(qd))


# ---- the stand-in and the models ------------------------------------------------

def test_stand_in_matches_jax():
    """The stand-in through both parsers: equal models; 23 scalar dofs, the
    arm's 7 first with symmetric limits (zero actions hold it upright);
    the fingertips index/middle/ring/thumb_link_3 with six candidates each,
    a palm; in the mid-range pose every fingertip lies more than 0.5 m
    from the cube's rest position (0, -0.8, 0.445)."""
    from isaacgymenvs_tpu.model import load_urdf as jload_urdf
    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics

    path = os.path.join(package_asset_root(), URDF)
    tm, jm = load_urdf(path, fix_base=True), jload_urdf(path, fix_base=True)
    _assert_models_equal(tm, jm)
    assert (tm.nq, tm.nv, tm.nbody) == (23, 23, 26)
    assert [tm.body_names[tm.dof_body[d]] for d in range(7)] == [f"iiwa7_link_{i}" for i in range(1, 8)]
    lo, hi = np.asarray(tm.dof_limit_lower), np.asarray(tm.dof_limit_upper)
    np.testing.assert_allclose(lo[:7], -hi[:7])
    tips = [tm.body_names.index(f"{f}_link_3") for f in ("index", "middle", "ring", "thumb")]
    assert [tm.cpoint_body.count(b) for b in tips] == [6] * 4
    assert any("palm" in n for n in tm.body_names)
    q = torch.tensor((lo + hi) / 2, dtype=torch.float32)[None]
    kin = forward_kinematics(tm, q, torch.zeros(1, 23))
    far = torch.linalg.vector_norm(kin.x[0, tips] - torch.tensor([0.0, -0.8, 0.445]), dim=-1)
    assert float(far.min()) > 0.5 and float(kin.x[0, tips, 2].min()) > 1.0, (far, kin.x[0, tips])


@pytest.mark.parametrize("task", TASKS)
def test_models_match_jax(task):
    """The composed scenes equal leaf by leaf (two arms at x = -/+1.1 with
    the wide table): the cube's 8 corners against the table and 6
    candidates per fingertip against the cube as pair rows, no plane rows,
    no cap; the indices the hooks read and the dims equal."""
    jenv, tenv = both(task)
    _assert_models_equal(tenv.model, jenv.model)
    m, p = tenv.model, tenv.sim_params
    s = tfused.spec_of(m)
    arms = tenv.NUM_ARMS
    assert (m.nv, s.nc, s.pp_nc, tfused.topk_cap(s, p)) == (6 + 23 * arms, 0, 8 + 24 * arms, 0)
    assert tfused.fused_supported(m, p)
    assert (tenv.oq, tenv.ov, tenv.num_obs, tenv.num_acts, tenv.num_keypoints) == (
        jenv.oq, jenv.ov, jenv.num_obs, jenv.num_acts, jenv.num_keypoints)
    for a in ("q_idx", "v_idx", "tip_bodies", "dof_lower", "dof_upper"):
        np.testing.assert_array_equal(getattr(tenv, a).numpy(), np.asarray(getattr(jenv, a)), err_msg=a)
    palms = np.asarray(jenv.palm_bodies) if arms == 2 else [jenv.palm_body]
    np.testing.assert_array_equal(tenv.palm_bodies.numpy(), palms)
    np.testing.assert_allclose(tenv.keypoint_offsets.numpy(), np.asarray(jenv.keypoint_offsets), atol=1e-7)
    for a in ("vol_origin", "vol_lo", "vol_hi"):
        np.testing.assert_allclose(getattr(tenv, a).numpy(), np.asarray(getattr(jenv, a)), err_msg=a)
    assert tenv.dr_actor_ranges() == jenv.dr_actor_ranges()


# ---- the hooks at drawn states ----------------------------------------------------

def drawn(jenv, tenv, seed):
    """N init states from the JAX resets (the arms' joints jittered, random
    velocities), the JAX task state with its keys, the port's from the same
    draws, random actions and progress; env 0 and 1 at the goal one step
    before a success (env 1 at a tolerance near its floor), env 2 lifted 0.2
    m by the step (the lift bonus, its progress at the episode's end), env 3
    fallen off the table."""
    from isaacgymenvs_tpu.envcore.vec_task import Sensors as JSensors
    from isaacgymenvs_tpu_torch.envcore.vec_task import Sensors

    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    jq, jqd, jtask = jax.vmap(jenv.sample_init)(keys)
    tq, tqd, ttask = tenv.init_from_draws(*jax_init_draws(jenv, keys),
                                          torch.full((N,), tenv.success_tolerance))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, err_msg="init q")
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=1e-6, err_msg="init qd")
    assert_task_equal(ttask, jtask, atol=1e-6)
    rng = np.random.RandomState(seed)
    m, oq = tenv.model, tenv.oq
    q = np.asarray(jq) + np.where(np.arange(m.nq) < oq, rng.uniform(-0.3, 0.3, (N, m.nq)), 0.0)
    qd = rng.uniform(-0.5, 0.5, (N, m.nv))
    q[:2, oq:oq + 3] = np.asarray(jtask["goal_pos"])[:2]
    q[:2, oq + 3:oq + 7] = np.asarray(jtask["goal_rot"])[:2]
    q[2, oq + 2] += 0.2
    q[3, oq + 2] = 0.05
    jtask = {**jtask, "near_goal_steps": jnp.full(N, tenv.success_steps - 1, jnp.int32),
             "tolerance": jnp.asarray([0.075, 0.0105, 0.05, 0.075], jnp.float32),
             "closest_tip_dist": jnp.asarray(rng.uniform(-0.5, 1.0, (N, 4 * tenv.NUM_ARMS)), jnp.float32),
             "closest_kp_dist": jnp.asarray([-1.0, 0.3, 2.0, 0.1], jnp.float32),
             "lifted": jnp.asarray([True, False, False, True]),
             "successes": jnp.asarray([3.0, 0.0, 1.0, 2.0], jnp.float32)}
    nb, nv = m.nbody, m.nv
    sens = [rng.normal(size=s).astype(np.float32) for s in ((N, nb, 3), (N, nb, 3), (N, nv))]
    acts = rng.uniform(-1, 1, (N, tenv.num_acts)).astype(np.float32)
    progress = np.asarray([0, 5, tenv.max_episode_length - 1, 3], np.int32)
    return (q.astype(np.float32), qd.astype(np.float32), jtask, JSensors(*map(jnp.asarray, sens)),
            Sensors(*map(torch.tensor, sens)), acts, progress, keys)


@pytest.mark.parametrize("task", TASKS)
def test_hooks_match_jax(task):
    """At states drawn from the JAX reset (the resets' draws make the same
    init, `init_from_draws`): `compute_force` (the PD targets over every
    dof), `observe`, and `reward_done` with JAX's goal draws: reward, done
    (a fall, a timeout, Regrasping's success), the task state (new goals
    where the goal is reached, the tolerance's decay to its floor, the
    counters, the closest distances, the lift flags, the reward terms); the
    extras; `resample_init` with JAX's draws (the tolerance carried;
    Regrasping's successes kept after a success, cleared otherwise)."""
    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics

    jenv, tenv = both(task)
    q, qd, jtask, jsens, tsens, acts, progress, keys = drawn(jenv, tenv, seed=3)
    ttask = port_task(jtask)
    tq, tqd, ta = torch.tensor(q), torch.tensor(qd), torch.tensor(acts)
    jq, jqd, ja = jnp.asarray(q), jnp.asarray(qd), jnp.asarray(acts)
    qfrc, xfrc, qt = tenv.compute_force(ta, tq, tqd, ttask)
    jqfrc, jxfrc, jqt = jax.vmap(jenv.compute_force)(ja, jq, jqd, jtask)
    for got, want, name in ((qfrc, jqfrc, "qfrc"), (xfrc, jxfrc, "xfrc"), (qt, jqt, "q_target")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=name)

    tkin, jkin = forward_kinematics(tenv.model, tq, tqd), jax_fk(jenv.model, q, qd)
    tp, jp = torch.tensor(progress), jnp.asarray(progress)
    args_t, args_j = (tq, tqd, tkin, tsens, ttask, ta, tp), (jq, jqd, jkin, jsens, jtask, ja, jp)
    obs, jobs = tenv.observe(*args_t), jax.vmap(jenv.observe)(*args_j)
    assert obs.shape == (N, tenv.num_obs) == tuple(jobs.shape)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5, rtol=1e-5, err_msg="observe")

    tenv.draws_of_step = lambda n: jax_step_draws(jenv, jtask)
    try:
        rew, done, new = tenv.reward_done(obs, *args_t)
    finally:
        del tenv.draws_of_step
    jrew, jdone, jnew = jax.vmap(jenv.reward_done)(jobs, *args_j)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-3, rtol=1e-5, err_msg="reward")
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert_task_equal(new, jnew)
    assert new["last_success"][:2].all() and not new["last_success"][2:].any()
    np.testing.assert_allclose(new["tolerance"].numpy(), [0.0675, 0.01, 0.05, 0.075], atol=1e-7)
    assert bool(done[2:].all()) and new["lifted"][2]
    ex = tenv.extra_outputs(tq, tqd, tkin, tsens, new, ta, tp)
    jex = jax.vmap(jenv.extra_outputs)(jq, jqd, jkin, jsens, jnew, ja, jp)
    assert set(ex) == set(jex) and set(ex["episode_cumulative"]) == set(jex["episode_cumulative"])
    for k in ("true_objective", "successes"):
        np.testing.assert_array_equal(ex[k].numpy(), np.asarray(jex[k]))

    # resets from the task state just left: the curriculum's tolerance and Regrasping's successes carried
    tenv.init_draws = lambda g, n: jax_init_draws(jenv, keys)
    try:
        iq, iqd, itask = tenv.resample_init(None, new)
    finally:
        del tenv.init_draws
    jiq, jiqd, jitask = jax.vmap(jenv.resample_init)(keys, jnew)
    np.testing.assert_allclose(iq.numpy(), np.asarray(jiq), atol=1e-6)
    np.testing.assert_allclose(iqd.numpy(), np.asarray(jiqd), atol=1e-6)
    assert_task_equal(itask, jitask, atol=1e-6)
    carried = "Reorientation" not in task  # Regrasping and Throw
    np.testing.assert_array_equal(itask["successes"].numpy(), [4.0, 1.0, 0.0, 0.0] if carried else [0.0] * 4)


def test_bank_resets_match_jax(tmp_path):
    """`loadInitialStates`: both packages read the same .npz bank, and a
    reset with JAX's draws takes JAX's bank rows (q, qd) with the PD targets
    at the fresh draw; `dump_env_states` writes the same rows as JAX's from
    the same snapshots and seed, appending to the bank."""
    from types import SimpleNamespace

    jenv, tenv = both("AllegroKukaReorientation")
    rng = np.random.RandomState(0)
    m = tenv.model
    snaps = [(rng.normal(size=(N, m.nq)).astype(np.float32), rng.normal(size=(N, m.nv)).astype(np.float32))
             for _ in range(23)]
    paths = {}
    for name, env, conv in (("jax", jenv, jnp.asarray), ("port", tenv, torch.tensor)):
        env._episode_q, env._episode_qd = [], []
        for sq, sqd in snaps:
            env.accumulate_env_states(SimpleNamespace(sim=SimpleNamespace(q=conv(sq), qd=conv(sqd))))
        paths[name] = str(tmp_path / f"{name}.npz")
        assert env.dump_env_states(paths[name], rng=7) == 2 * N
        assert env._episode_q == []
    a, b = np.load(paths["jax"]), np.load(paths["port"])
    np.testing.assert_array_equal(a["q"], b["q"])
    np.testing.assert_array_equal(a["qd"], b["qd"])
    jb, tb = both("AllegroKukaReorientation", ("task.env.loadInitialStates=True",
                                               f"task.env.loadStatesFile={paths['port']}"))
    keys = jax.random.split(jax.random.PRNGKey(4), N)
    draws = jax_init_draws(jb, keys, nbank=2 * N)
    tq, tqd, ttask = tb.init_from_draws(*draws, torch.full((N,), tb.success_tolerance))
    jq, jqd, jtask = jax.vmap(jb.sample_init)(keys)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tqd.numpy(), np.asarray(jqd))
    np.testing.assert_array_equal(tq.numpy(), b["q"][draws[5].numpy()])
    assert_task_equal(ttask, jtask, atol=1e-6)


# ---- the physics step ---------------------------------------------------------------

def held_calls(env, q, qd):
    """compute_force with the PD targets held at the joints' positions."""
    from isaacgymenvs_tpu_torch import maths

    held = torch.clamp(maths.unscale(q[:, env.q_idx], env.dof_lower, env.dof_upper), -1.0, 1.0)
    return env.compute_force(held, q, qd, None)


def plain_step_matches_jax(task, n):
    """The plain step against JAX `physics_step_fused(use_pallas=False)` at
    the task's `contact_states` (n envs) under the PD targets held at the
    joints, on the envs `torch_conditioning.kept` keeps: q 2e-4, qd 2e-3,
    forces 2e-2; force on the cube in the kept envs, a fingertip's in some."""
    from isaacgymenvs_tpu.engine import fused as jfused

    jenv, tenv = both(task)
    q, qd = tenv.contact_states(n, seed=5)
    qfrc, xfrc, qt = held_calls(tenv, q, qd)
    m, p = tenv.model, tenv.sim_params
    s = tfused.spec_of(m)
    keep = cond.kept(cond.port_gaps(s, p, q, qd, qfrc, xfrc, qt),
                     cond.jax_gaps(jenv.model, jenv.sim_params, q, qd, qfrc, xfrc, qt))
    assert int(keep.sum()) >= n // 2, keep
    tout = tfused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=qt)
    jout = jfused.physics_step_fused(jenv.model, jenv.sim_params, jnp.asarray(q.numpy()), jnp.asarray(qd.numpy()),
                                     jnp.asarray(qfrc.numpy()), xfrc=jnp.asarray(xfrc.numpy()),
                                     q_target=jnp.asarray(qt.numpy()), use_pallas=False)
    k_ = keep.numpy()
    for k, tol in TOL.items():
        np.testing.assert_allclose(getattr(tout, k).numpy()[k_], np.asarray(getattr(jout, k))[k_], atol=tol,
                                   err_msg=k)
    bf = np.linalg.norm(np.asarray(jout.body_force), axis=-1)[k_]
    assert (bf[:, tenv.obj_body] > 0.01).all(), bf[:, tenv.obj_body]
    assert (bf[:, tenv.tip_bodies.numpy()] > 1e-3).any()


def test_plain_step_matches_jax():
    """One arm, 12 states: in 8 the cube on the highest fingertip, in 4 on the table."""
    plain_step_matches_jax("AllegroKukaReorientation", 12)


def fields(js):
    return {"q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf,
            "actions": js.actions, "task": jax.tree.map(np.asarray, js.task)}


def env_steps_match_jax(task, jenv, tenv, steps=3):
    """The port's observation of the JAX reset state equals the JAX reset's;
    from the port's `contact_states`, put on both, `steps` env steps of
    gentle random actions against the JAX step run op by op, the port
    taking JAX's goal draws: q, qd, observation, reward, done, the task
    state and the extras. Each step starts both from the JAX state (a cube
    resting on a fingertip grows a difference within the tolerances from
    step to step), and its physics call is first held to
    `torch_conditioning.kept` (the port's float64 call against JAX's on
    every env); an env whose call is ill-conditioned for both packages is
    left out of the comparison from that step on, and half the envs or more
    stay compared."""
    n = tenv.num_envs
    jstate, jobs = jenv.reset(jax.random.PRNGKey(0))
    tstate = env_state_from_arrays(tenv.reset(0)[0], fields(jstate), "cpu")
    obs = tenv.observe(tstate.sim.q, tstate.sim.qd, tenv._kin(tstate.sim.q, tstate.sim.qd), tenv._no_sensors(n),
                       tstate.task, tstate.actions, tstate.progress)
    np.testing.assert_allclose(torch.clamp(obs, -tenv.clip_obs, tenv.clip_obs).numpy(), np.asarray(jobs), atol=1e-5)
    q, qd = tenv.contact_states(n, seed=7)
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q.numpy()), qd=jnp.asarray(qd.numpy())))
    tstate = env_state_from_arrays(tstate, fields(jstate), "cpu")
    rng = np.random.RandomState(8)
    s, p = tfused.spec_of(tenv.model), tenv.sim_params
    keep = torch.ones(n, dtype=torch.bool)
    try:
        for k in range(steps):
            a = rng.uniform(-0.1, 0.1, (n, tenv.num_acts)).astype(np.float32)
            x = (tstate.sim.q, tstate.sim.qd, *tenv.compute_force(torch.tensor(a), tstate.sim.q, tstate.sim.qd,
                                                                  tstate.task))
            keep &= cond.kept(cond.port_gaps(s, p, *x), cond.jax_gaps(jenv.model, jenv.sim_params, *x))
            tenv.draws_of_step = lambda _, t=jstate.task: jax_step_draws(jenv, t)
            jstate, jobs, jrew, jdone, jex = jenv.step(jstate, jnp.asarray(a))
            tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
            k_ = keep.numpy()
            for got, want, tol, name in ((tstate.sim.q, jstate.sim.q, TOL["q"], "q"),
                                         (tstate.sim.qd, jstate.sim.qd, TOL["qd"], "qd"),
                                         (tobs, jobs, TOL["qd"], "obs"), (trew, jrew, 1e-3, "reward")):
                np.testing.assert_allclose(got.numpy()[k_], np.asarray(want)[k_], atol=tol, err_msg=f"{name} {k}")
            np.testing.assert_array_equal(tdone.numpy()[k_], np.asarray(jdone)[k_])
            for name in ("goal_pos", "goal_rot", "successes", "tolerance", "lifted", "closest_tip_dist",
                         "closest_kp_dist"):
                np.testing.assert_allclose(tstate.task[name].numpy().astype(np.float32)[k_],
                                           np.asarray(jstate.task[name], np.float32)[k_], atol=1e-3, err_msg=name)
            for name in ("successes", "time_outs"):
                np.testing.assert_array_equal(tex[name].numpy()[k_], np.asarray(jex[name])[k_], err_msg=name)
            tstate = env_state_from_arrays(tstate, fields(jstate), "cpu")
    finally:
        del tenv.draws_of_step
    assert int(keep.sum()) >= n // 2, keep
    assert bool(torch.isfinite(tstate.sim.q).all()) and tobs.shape == (n, tenv.num_obs)


def test_reset_and_env_steps_match_jax():
    jenv, tenv = both("AllegroKukaReorientation")
    env_steps_match_jax("AllegroKukaReorientation", jenv, tenv)


# ---- configs, resolvers, randomization ---------------------------------------------

CONFIGS = [("AllegroKuka", (), "AllegroKukaReorientation"),
           ("AllegroKuka", ("task.env.subtask=reorientation",), "AllegroKukaReorientation"),
           ("AllegroKuka", ("task.env.subtask=regrasping",), "AllegroKukaRegrasping"),
           ("AllegroKuka", ("task.env.subtask=throw",), "AllegroKukaThrow"),
           ("AllegroKukaLSTM", (), "AllegroKukaReorientation"),
           ("AllegroKukaReorientation", (), "AllegroKukaReorientation"),
           ("AllegroKukaRegrasping", (), "AllegroKukaRegrasping"),
           ("AllegroKukaThrow", (), "AllegroKukaThrow"),
           ("AllegroKukaTwoArms", (), "AllegroKukaTwoArmsReorientation"),
           ("AllegroKukaTwoArms", ("task.env.subtask=regrasping",), "AllegroKukaTwoArmsRegrasping"),
           ("AllegroKukaTwoArmsLSTM", (), "AllegroKukaTwoArmsReorientation"),
           ("AllegroKukaTwoArmsReorientation", (), "AllegroKukaTwoArmsReorientation"),
           ("AllegroKukaTwoArmsRegrasping", (), "AllegroKukaTwoArmsRegrasping")]


@pytest.mark.parametrize("task,extra,cls", CONFIGS, ids=lambda v: "-".join(v) if isinstance(v, tuple) else v)
def test_configs_and_resolvers_match_jax(task, extra, cls):
    """`load_config` gives the JAX package's dict (but for the device flags)
    for each AllegroKuka task yaml and its recipe, the env-subtask group
    merged (`task.env.subtask=`: the group's episodeLength and successSteps,
    and a CLI override still winning); the class `train.main` builds (the
    resolvers of `task=AllegroKuka` and `task=AllegroKukaTwoArms`, the LSTM
    yamls through their `name:`) is JAX's."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config

    args = [f"task={task}", "num_envs=2", *extra]
    cfg, jcfg = load_config(args), jload(args)
    for c in (cfg, jcfg):
        for k in ("sim_device", "rl_device", "device"):
            c.pop(k, None)
    assert cfg == jcfg
    assert bool(cfg["train"]["params"]["network"].get("rnn")) == ("LSTM" in task)
    name = task if task in ttasks else cfg["task"]["name"]
    env = ttasks[name](cfg["task"], device="cpu")
    jname = task if task in jtasks else jcfg["task"]["name"]
    assert type(env).__name__ == cls
    if "subtask=regrasping" in extra:
        assert env.max_episode_length == 300 and env.success_steps == 30
        over = load_config([*args, "task.env.successSteps=3"])["task"]["env"]
        assert over["successSteps"] == 3 and over["episodeLength"] == 300
    if "subtask=throw" in extra:
        assert env.target_tolerance == 0.075 and env.success_steps == 5
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        assert type(jtasks[jname](jcfg["task"])).__name__ == cls


def test_unknown_subtask_raises():
    from isaacgymenvs_tpu_torch.tasks import resolve_allegro_kuka, resolve_allegro_kuka_two_arms

    for resolve in (resolve_allegro_kuka, resolve_allegro_kuka_two_arms):
        with pytest.raises(ValueError, match="Unknown subtask"):
            resolve({"env": {"subtask": "juggling", "numEnvs": 2}}, device="cpu")


def test_randomized_leaves_match_jax():
    """`task.randomize=True` on AllegroKukaReorientation.yaml: with one
    sample drawn by the JAX randomizer, carried across
    (`convert.dr_sample_from_jax`), the per-env leaves (the allegro and
    object actor ranges' dof stiffness, damping and limits, masses,
    friction, the object's scale on its candidates and geom) and the
    gravity equal JAX's (rtol 1e-6); the packed leaves' names are the same
    set; a randomized env steps finitely."""
    jenv, tenv = both("AllegroKukaReorientation", ("task.task.randomize=True",))
    trz, jrz = tenv.randomizer, jenv.randomizer
    assert trz is not None and trz.batched_leaf_names() == jrz.batched_leaf_names()
    assert {"dof_stiffness", "dof_damping", "dof_limit_lower", "dof_limit_upper", "body_mass",
            "cpoint_friction", "cpoint_pos"} <= set(trz.batched_leaf_names())
    jsample = jrz.sample(jax.random.PRNGKey(5), N, jnp.zeros((), jnp.int32))
    tsample = dr_sample_from_jax({k: np.asarray(v) for k, v in jsample.items()})
    want, got = jrz.batched_model(jenv.model, jsample), trz.batched_model(tsample)
    assert set(got) == jrz.batched_leaf_names()
    for leaf, val in got.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(getattr(want, leaf)), rtol=1e-6, atol=1e-9, err_msg=leaf)
    np.testing.assert_allclose(trz.gravity(tenv.sim_params.gravity, tsample).numpy(),
                               np.asarray(jrz.gravity(jnp.asarray(jenv.sim_params.gravity), jsample)), rtol=1e-6)
    cube = tenv.obj_body
    scale = tsample["object.scale"].numpy()[:, 0] if tsample["object.scale"].dim() > 1 else \
        tsample["object.scale"].numpy()
    mass = got["body_mass"].numpy()[:, cube] / float(np.asarray(tenv.model.body_mass)[cube])
    np.testing.assert_allclose(mass, tsample["object.rigid_body_properties.mass"].numpy()[:, cube] * scale ** 3,
                               rtol=1e-5)
    state, _ = tenv.reset(0)
    state.dr = tsample
    state.dyn = tenv.pack_dyn(tsample)
    state, obs, rew, done, _ = tenv.step(state, torch.zeros(N, tenv.num_acts))
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(rew).all())


# ---- tests/test_allegro_kuka.py and tests/test_ppo.py, the port's counterparts -------

def make(name="AllegroKukaReorientation", num_envs=4, **env_kw):
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={name}", f"num_envs={num_envs}"])["task"]
    cfg["env"].update(env_kw)
    return task_map[name](cfg, device="cpu")


def test_contract_and_cube_rests_on_table():
    """117 observations, 23 actions; after 25 zero-action steps the cube
    lies within 5e-3 of its rest height in every env (the bar chip_smoke.py
    holds the kernel to at 8,192 envs, PERF.md); `true_objective` in the
    extras."""
    from isaacgymenvs_tpu_torch.tasks.allegro_kuka import OBJ_SIZE, TABLE_TOP

    env = make(num_envs=8)
    assert env.num_obs == 117 and env.num_acts == 23
    state, obs = env.reset(0)
    assert obs.shape == (8, 117)
    for _ in range(25):
        state, obs, rew, done, ex = env.step(state, torch.zeros(8, 23))
    assert bool(torch.isfinite(obs).all())
    cz = state.sim.q[:, env.oq + 2]
    assert float((cz - (TABLE_TOP + OBJ_SIZE / 2)).abs().max()) < 5e-3, cz
    assert "true_objective" in ex


def test_keypoint_reward_gated_on_lifting():
    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics

    env = make(num_envs=1)
    state, obs = env.reset(1)
    q, qd = state.sim.q, state.sim.qd
    kin = forward_kinematics(env.model, q, qd)
    task = {**state.task, "closest_kp_dist": torch.tensor([10.0]), "lifted": torch.tensor([False])}
    r_unlifted, _, _ = env.reward_done(obs, q, qd, kin, None, task, torch.zeros(1, 23), torch.tensor([1]))
    task2 = {**task, "lifted": torch.tensor([True]), "closest_tip_dist": torch.zeros(1, 4)}
    r_lifted, _, _ = env.reward_done(obs, q, qd, kin, None, task2, torch.zeros(1, 23), torch.tensor([1]))
    assert float(r_lifted) > float(r_unlifted) + 100.0


def test_tolerance_curriculum_persists_across_resets():
    env = make(num_envs=4, episodeLength=3)
    state, obs = env.reset(2)
    state.task["tolerance"] = torch.full((4,), 0.02)
    for _ in range(8):  # several episode boundaries
        state, obs, rew, done, ex = env.step(state, torch.zeros(4, 23))
    np.testing.assert_allclose(state.task["tolerance"].numpy(), 0.02)


def test_regrasping_success_ends_episode_and_carries_successes():
    env = make("AllegroKukaRegrasping")
    assert env.num_keypoints == 1 and env.num_obs == 99
    state, obs = env.reset(3)
    state.task["last_success"] = torch.tensor([True, False, False, False])
    state.task["successes"] = torch.tensor([3.0, 2.0, 0.0, 0.0])
    state.reset_buf = torch.tensor([True, True, False, False])
    state, obs, rew, done, ex = env.step(state, torch.zeros(4, 23))
    succ = state.task["successes"].numpy()
    assert succ[0] == 3.0 and succ[1] == 0.0


def test_initial_state_bank_roundtrip(tmp_path):
    """saveStates / loadInitialStates: snapshots of a rollout dumped to a
    bank (25 // 10 = 2 per env), appended by a second dump; an env with
    loadInitialStates resets every env to a bank row."""
    bank = str(tmp_path / "kuka_states.npz")
    env = make(num_envs=2, saveStates=True, saveStatesFile=bank)
    state, obs = env.reset(0)
    for _ in range(25):
        state, obs, rew, done, ex = env.step(state, torch.zeros(2, 23))
        env.accumulate_env_states(state)
    assert env.dump_env_states(rng=0) == 2 * 2
    for _ in range(25):
        state, obs, rew, done, ex = env.step(state, torch.zeros(2, 23))
        env.accumulate_env_states(state)
    assert env.dump_env_states(rng=1) == 8
    env2 = make(num_envs=4, loadInitialStates=True, loadStatesFile=bank)
    state2, obs2 = env2.reset(2)
    data = np.load(bank)
    q2 = state2.sim.q.numpy()
    for e in range(4):
        assert np.abs(data["q"] - q2[e][None]).max(axis=-1).min() < 1e-5, e
    assert bool(torch.isfinite(obs2).all())
    # a partial reset draws bank rows too
    state2.reset_buf = torch.tensor([True, False, True, False])
    state2, obs2, _, _, _ = env2.step(state2, torch.zeros(4, 23))
    assert all(np.abs(data["q"] - state2.sim.q.numpy()[e][None]).max(axis=-1).min() < 1e-5 for e in (0, 2))


def test_save_states_wired_into_train_loop(tmp_path, monkeypatch):
    """saveStates with a saveStatesFile: PPO.train (and PPORecurrent, which
    inherits it) takes one snapshot per epoch and dumps at exit."""
    from isaacgymenvs_tpu_torch.learn import PPO, PPORecurrent

    for kind, net in ((PPO, {}), (PPORecurrent, {"network": {"mlp": {"units": [16]},
                                                             "rnn": {"name": "lstm", "units": 8}}})):
        bank = str(tmp_path / f"{kind.__name__}.npz")
        env = make(num_envs=2, saveStates=True, saveStatesFile=bank)
        calls = {"acc": 0, "dump": 0}
        real_acc = env.accumulate_env_states
        monkeypatch.setattr(env, "accumulate_env_states",
                            lambda s: (calls.__setitem__("acc", calls["acc"] + 1), real_acc(s)))
        monkeypatch.setattr(env, "dump_env_states", lambda *a, **k: calls.__setitem__("dump", calls["dump"] + 1))
        agent = kind(env, {**net, "config": {"horizon_length": 4, "minibatch_size": 8, "mini_epochs": 1,
                                             "max_epochs": 2, "seq_len": 4}}, seed=0)
        agent.train(max_epochs=2, log_every=100)
        assert calls == {"acc": 2, "dump": 1}, kind
        assert len(env._episode_q) == 2


def test_allegro_kuka_emits_episode_cumulative():
    """The per-step reward terms reach the trainer's epoch metrics as
    `episode_cumulative/<term>`."""
    from isaacgymenvs_tpu_torch.learn import PPO

    env = make(num_envs=4)
    agent = PPO(env, {"config": {"horizon_length": 2, "minibatch_size": 8, "mini_epochs": 1}}, seed=0)
    ts = agent.init()
    assert ts.ep_cum is None  # the sums start at the first step that emits terms
    ts, metrics = agent.train_epoch(ts)
    assert set(ts.ep_cum) == set(env.REW_TERMS) and "lifting_rew" in ts.ep_cum
    assert "episode_cumulative/keypoint_rew" in metrics
