"""The port's DeXtreme tasks (AllegroHandDextremeADR, AllegroHandDextremeManualDR)
and the Random Network Adversary against the JAX package, on the CPU: the
RNA's weights and output; the hooks at drawn states with JAX's corruption,
goal and kick draws handed over (`compute_force` through the latency queue,
the latency cap, the affine noise and the RNA under the annealed moving
average; `observe` with the camera's latched pose; `observe_state`;
`reward_done` with the replay of the corruption, the camera latch, the
queue push and the extra reward terms); the plain step on the task's
contact states under the ADR yaml's per-env physics leaves, boundary
workers pinned at both edges of each leaf; a reset and env steps with ADR
on; the yamls and the four task names; and the port's counterparts of
tests/test_dextreme.py.

The JAX task folds its per-step draws from a PRNG key in its task state; the
port draws them once per env step from its generator (`corruption_draws`,
`draws_of_step`): the tests hand the port JAX's. Tolerances: the RNA's
weights bit-equal, its output 1e-6; hooks 1e-5 (observations 1e-4, rewards
1e-3 as tests/test_torch_hands.py); the plain step and the env steps q
2e-4, qd 2e-3, forces 2e-2 (tests/test_fused.py:79-82) on every env;
observations and rewards of the env steps 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.convert import dr_sample_from_jax, env_state_from_arrays, task_from_arrays
from isaacgymenvs_tpu_torch.dr.adr import AdrState
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from isaacgymenvs_tpu_torch.utils.rna import RandomNetworkAdversary
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 4
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
TASKS = ["AllegroHandDextremeADR", "AllegroHandDextremeManualDR"]
DRAW_KEYS = ("delay_u", "act_white", "dof_white", "cube_white", "hold_u")
_ENVS = {}


@pytest.fixture(autouse=True)
def _jax_assets(monkeypatch):
    monkeypatch.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())


def _both(task, n=N, extra=()):
    """The JAX env (its step through the fused math) and the port's env of
    `task` at n envs, built once per worker."""
    key = (task, n, tuple(extra))
    if key not in _ENVS:
        from isaacgymenvs_tpu.tasks import task_map as jtasks
        from isaacgymenvs_tpu.utils.config import load_config as jload
        from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
        from isaacgymenvs_tpu_torch.utils.config import load_config as tload

        args = [f"task={task}", f"num_envs={n}", *extra]
        jcfg = jload(args)["task"]
        jcfg["sim"]["use_fused"] = True
        jenv = jtasks[jcfg["name"]](jcfg)
        _ENVS[key] = (jenv, ttasks[jcfg["name"]](tload(args)["task"], device="cpu"))
    return _ENVS[key]


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def jax_corruption_draws(jtask):
    """The draws the JAX hooks fold from each env's task key: the latency's
    extra step (17-19: its uniform, the white action noise), the observation
    noise (23, 24) and the camera hold (29)."""
    def one(k):
        f = lambda c: jax.random.fold_in(k, c)
        return (jax.random.uniform(f(19), ()), jax.random.normal(f(18), (16,)), jax.random.normal(f(23), (16,)),
                jax.random.normal(f(24), (7,)), jax.random.uniform(f(29), ()))

    return {k: _t(v) for k, v in zip(DRAW_KEYS, jax.vmap(one)(jtask["key"]))}


def jax_step_draws(jtask):
    """The goal and kick draws of the JAX reward_done: the new goal's normal
    (4,) (a uniform random quaternion), the kick's uniform and its force's
    normal (3,)."""
    def one(key):
        _, kg, kf, kfd = jax.random.split(key, 4)
        return jax.random.normal(kg, (4,)), jax.random.uniform(kf, ()), jax.random.normal(kfd, (3,))

    return tuple(_t(a) for a in jax.vmap(one)(jtask["key"]))


def port_task(jtask):
    return task_from_arrays(jax.tree.map(np.asarray, jtask), "cpu")


def port_adr(js) -> AdrState:
    return AdrState(lo=_t(js.lo), hi=_t(js.hi), queues=_t(js.queues), counts=_t(js.counts).long(),
                    worker_boundary=_t(js.worker_boundary).long(), nats=_t(js.nats))


def assert_task_equal(got, want, atol=1e-5, keys=None):
    for k, v in port_task(want).items():
        if keys is not None and k not in keys:
            continue
        if k == "rew_terms":
            for kk in v:
                np.testing.assert_allclose(got[k][kk].numpy().astype(np.float64), v[kk].numpy().astype(np.float64),
                                           atol=1e-3, rtol=1e-5, err_msg=kk)
        else:
            np.testing.assert_allclose(got[k].numpy().astype(np.float64), v.numpy().astype(np.float64), atol=atol,
                                       err_msg=k)


def _jax_fk(jm, q, qd):
    from isaacgymenvs_tpu.engine import dynamics as jdyn

    return jax.jit(jax.vmap(lambda a, b: jdyn.forward_kinematics(jm, a, b)))(jnp.asarray(q), jnp.asarray(qd))


# ---- the Random Network Adversary ------------------------------------------------


def test_rna_matches_jax():
    """The weights drawn from the seed are bit-equal to JAX's; with JAX's
    per-env masks, the output equals JAX's within 1e-6 and lies in [-1, 1]."""
    from isaacgymenvs_tpu.utils.rna import RandomNetworkAdversary as JRNA

    jr = JRNA(in_dim=23, num_actions=16, seed=3)
    tr = RandomNetworkAdversary(in_dim=23, num_actions=16, seed=3, device="cpu")
    for name in ("w1", "b1", "w2", "b2", "w3"):
        assert np.array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name))), name
    np.testing.assert_allclose(tr.bin_centers.numpy(), np.asarray(jr.bin_centers), atol=1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    masks = jax.vmap(jr.sample_mask)(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (2, 64)))(keys)
    np.testing.assert_array_equal(tr.mask_from_draws(_t(u)).numpy(), np.asarray(masks))
    x = np.random.RandomState(1).uniform(-1, 1, (8, 23)).astype(np.float32)
    want = np.asarray(jax.vmap(jr)(masks, jnp.asarray(x)))
    got = tr(_t(masks), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(got).max() <= 1.0


def test_rna_output_bounded_and_mask_dependent():
    rna = RandomNetworkAdversary(in_dim=23, num_actions=16, seed=3, device="cpu")
    m = rna.sample_mask(torch.Generator().manual_seed(0), 2)
    x = torch.linspace(-1, 1, 23).expand(2, 23)
    a = rna(m, x)
    assert a.shape == (2, 16) and float(a.abs().max()) <= 1.0
    assert not torch.allclose(a[0], a[1])  # per-env masks diversify


# ---- the hooks at drawn states ------------------------------------------------------

# per ADR parameter, the range its drawn values span in the hooks' comparison: latencies past ManualDR's
# cap, delays and camera holds in half the envs, every noise and the RNA at work
ADR_DRAWN = {"action_latency": (0.0, 5.0), "action_delay_prob": (0.0, 1.0), "cube_pose_refresh_rate": (1.0, 3.0),
             "cube_obs_delay_prob": (0.0, 1.0), "rna_alpha": (0.0, 1.0)}
# the env-step count in the task: ADR's moving average 0.6 of the way through its 1e6-step anneal; ManualDR's
# latency cap at 3 of 15 (0.24 of its 1e7 steps)
FRAMES = {"AllegroHandDextremeADR": 600_000, "AllegroHandDextremeManualDR": 2_400_000}


def _drawn(jenv, tenv, seed):
    """N states from the JAX reset draws (the hand's joints jittered, random
    velocities, sensors, actions, progress), with JAX's task state: random
    ADR values, latency queue, camera pose and age."""
    from isaacgymenvs_tpu.envcore.vec_task import Sensors as JSensors
    from isaacgymenvs_tpu_torch.envcore.vec_task import Sensors

    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    jq, jqd, jtask = jax.vmap(jenv.sample_init)(keys)
    rng = np.random.RandomState(seed)
    m = tenv.model
    q = np.asarray(jq) + np.where(np.arange(m.nq) < tenv.obj_q, rng.uniform(-0.05, 0.05, (N, m.nq)), 0)
    qd = rng.uniform(-0.5, 0.5, (N, m.nv)).astype(np.float32)
    sens = [rng.normal(size=s).astype(np.float32) for s in ((N, m.nbody, 3), (N, m.nbody, 3), (N, m.nv))]
    acts = rng.uniform(-1, 1, (N, 16)).astype(np.float32)
    progress = np.asarray([0, 5, tenv.max_episode_length - 1, 3], np.int32)
    adr = rng.uniform(0.0, 0.1, (N, tenv.adr.P)).astype(np.float32)
    for name, (lo, hi) in ADR_DRAWN.items():
        adr[:, tenv._ai[name]] = rng.uniform(lo, hi, N)
    oq = tenv.obj_q
    jtask = {**jtask, "adr": jnp.asarray(adr), "act_hist": jnp.asarray(rng.uniform(-1, 1, (N, 16, 16)), jnp.float32),
             "cube_obs": jnp.asarray(q[:, oq:oq + 7] + rng.uniform(-0.01, 0.01, (N, 7)), jnp.float32),
             "cube_age": jnp.asarray([0, 1, 2, 5], jnp.int32),
             "rb_force": jnp.asarray(rng.normal(size=(N, 3)), jnp.float32)}
    return (q.astype(np.float32), qd, jtask, JSensors(*map(jnp.asarray, sens)), Sensors(*map(torch.tensor, sens)),
            acts, progress)


@pytest.mark.parametrize("task", TASKS)
def test_hooks_match_jax(task):
    """At drawn states, with JAX's draws handed over and the env-step count
    FRAMES[task] in the task (`_frames`): the reset's draws make JAX's init state;
    `compute_force` (the corrupted action's PD targets under the annealed
    moving average; ManualDR's latency cap binding in some env), `observe`,
    `observe_state` and `reward_done` (reward, done, and the task state:
    goal, successes, targets from the replayed corruption, the latency queue,
    the camera's pose and age, the carried corruption state) equal JAX's."""
    jenv, tenv = _both(task)
    q, qd, jtask, jsens, tsens, acts, progress = _drawn(jenv, tenv, seed=3)
    # the reset's draws
    keys = jax.random.split(jax.random.PRNGKey(3), N)

    def draws(k):
        rng, kb, kr = jax.random.split(k, 3)
        kd, kv, kp, krot, kg, kfp, _ = jax.random.split(rng, 7)
        u = lambda kk, n: jax.random.uniform(kk, (n,), minval=-1.0, maxval=1.0)
        ka, kdd, kc = jax.random.split(kb, 3)
        return (u(kd, 16), u(kv, 16), u(kp, 3), jax.random.normal(krot, (4,)), jax.random.normal(kg, (4,)),
                jax.random.uniform(kfp, ()), jax.random.normal(ka, (16,)), jax.random.normal(kdd, (16,)),
                jax.random.normal(kc, (7,)), jax.random.uniform(kr, (2, 64)))

    d = [_t(a) for a in jax.vmap(draws)(keys)]
    iq, iqd, itask = tenv.init_from_draws(*d[:9], tenv.rna.mask_from_draws(d[9]))
    jq0, jqd0, jtask0 = jax.vmap(jenv.sample_init)(keys)
    np.testing.assert_allclose(iq.numpy(), np.asarray(jq0), atol=1e-6)
    np.testing.assert_allclose(iqd.numpy(), np.asarray(jqd0), atol=1e-6)
    assert_task_equal(itask, jtask0, atol=1e-6, keys=set(itask) - {"rew_terms"})

    ttask = {**port_task(jtask), "_frames": torch.tensor(FRAMES[task], dtype=torch.int32)}
    jtask_f = {**jtask, "_frames": jnp.full((N,), FRAMES[task], jnp.int32)}
    tenv._draws = jax_corruption_draws(jtask)
    tq, tqd, ta, tp = torch.tensor(q), torch.tensor(qd), torch.tensor(acts), torch.tensor(progress)
    jq, jqd, ja, jp = jnp.asarray(q), jnp.asarray(qd), jnp.asarray(acts), jnp.asarray(progress)
    lat = torch.floor(ttask["adr"][:, tenv._ai["action_latency"]]) + 1
    if task.endswith("ManualDR"):
        assert int(tenv._latency_cap(ttask)) == 3 and bool((lat > 3).any())
    assert float(tenv._act_ma(ttask)) == pytest.approx(float(jenv._act_ma(jtask_f)[0]))

    for got, want, name in zip(tenv.compute_force(ta, tq, tqd, ttask),
                               jax.vmap(jenv.compute_force)(ja, jq, jqd, jtask_f), ("qfrc", "xfrc", "q_target")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=name)

    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics

    tkin, jkin = forward_kinematics(tenv.model, tq, tqd), _jax_fk(jenv.model, q, qd)
    args_t = (tq, tqd, tkin, tsens, ttask, ta, tp)
    args_j = (jq, jqd, jkin, jsens, jtask_f, ja, jp)
    obs, jobs = tenv.observe(*args_t), jax.vmap(jenv.observe)(*args_j)
    assert obs.shape == (N, 47) == tuple(jobs.shape)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5, err_msg="observe")
    st, jst = tenv.observe_state(*args_t), jax.vmap(jenv.observe_state)(*args_j)
    assert st.shape == (N, 88)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-4, rtol=1e-5, err_msg="observe_state")

    # the goal reached in two envs: successes and new goals from the draws (ManualDR: the hold counts)
    oq = tenv.obj_q
    tq[:2, oq + 3:oq + 7] = ttask["goal_rot"][:2]
    jq = jnp.asarray(tq.numpy())
    tkin, jkin = forward_kinematics(tenv.model, tq, tqd), _jax_fk(jenv.model, tq.numpy(), qd)
    args_t = (tq, tqd, tkin, tsens, ttask, ta, tp)
    args_j = (jq, jqd, jkin, jsens, jtask_f, ja, jp)
    tenv.draws_of_step = lambda n: jax_step_draws(jtask)
    try:
        rew, done, new = tenv.reward_done(obs, *args_t)
    finally:
        del tenv.draws_of_step
    jrew, jdone, jnew = jax.vmap(jenv.reward_done)(jobs, *args_j)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-3, rtol=1e-5, err_msg="reward")
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert set(new) == set(port_task(jnew))
    assert_task_equal(new, jnew)
    if tenv.num_success_hold_steps == 0:
        assert float(new["successes"][:2].min()) >= 1.0
    else:  # ManualDR holds the goal one step past the first before it counts
        assert int(new["hold"][:2].min()) >= 1
    # the camera refreshed in some env and held in another; the queue took the raw actions
    assert bool((new["cube_age"] == 0).any()) and bool((new["cube_age"] > 0).any())
    np.testing.assert_array_equal(new["act_hist"][:, 0].numpy(), acts)
    np.testing.assert_allclose(tenv.adr_objective(new).numpy(), new["successes"].numpy())


# ---- the physics: the plain step under the ADR yaml's per-env leaves -------------------

def _held(tenv, q, qd):
    """compute_force of the hand (no corruption) with the setpoints held at the joints' positions."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.tasks.allegro_hand import AllegroHand

    idx, held = tenv.actuated_idx, q[:, tenv.hand_q_idx]
    hold = torch.clamp(maths.unscale(held[:, idx], tenv.dof_lower[idx], tenv.dof_upper[idx]), -1.0, 1.0)
    return AllegroHand.compute_force(tenv, hold, q, qd, {"targets": held, "rb_force": torch.zeros(q.shape[0], 3)})


def jax_dyn(jenv, jsample, names):
    """JAX's per-env leaves (and gravity) of a DR sample as its fused step takes them."""
    rz = jenv.randomizer
    bm = rz.batched_model(jenv.model, jsample)
    out = {k: np.asarray(getattr(bm, k)) for k in names if k != "gravity"}
    if "gravity" in names:
        out["gravity"] = np.asarray(rz.gravity(jnp.asarray(jenv.sim_params.gravity), jsample))
    return out


def pinned_adr(jenv, n):
    """JAX's initial ADR state at n envs with the first 22 envs boundary
    workers of the eleven physics parameters, one at each edge of each, the
    rest rollout workers; its ranges moved off the DR spec's."""
    js = jenv.adr.init_state(jax.random.PRNGKey(11))
    phys = sorted(jenv.adr.dr_params.values())
    wb = np.full(n, -1)
    for i, p in enumerate(phys):
        wb[2 * i:2 * i + 2] = (2 * p, 2 * p + 1)
    return js.replace(worker_boundary=jnp.asarray(wb, js.worker_boundary.dtype), lo=js.lo * 0.9,
                      hi=js.hi * 1.2 + 0.02)


def test_plain_step_matches_jax():
    """At 24 of the task's `contact_states` (the cube on the palm; one in
    three flat and pushed 2-4 mm in), under setpoints held at the joints,
    with the per-env leaves of a JAX DR draw from the ADR yaml under
    `pinned_adr` (each of the eleven physics parameters pinned at both
    edges in two envs; damping, stiffness, joint friction, armature, masses,
    friction and restitution as the kernel's leaves, the restitution's bounce
    branch on): the port's plain step against JAX
    `physics_step_fused(use_pallas=False)` on every env (q 2e-4, qd 2e-3,
    forces 2e-2); the cube carries contact force in half of the envs or
    more."""
    from isaacgymenvs_tpu.engine import fused as jfused

    jenv, tenv = _both("AllegroHandDextremeADR")
    n = 24
    q, qd = tenv.contact_states(n, seed=5)
    qfrc, xfrc, qt = _held(tenv, q, qd)
    js = pinned_adr(jenv, n)
    overrides = jenv.adr.dr_overrides(js)
    jsample = jenv.randomizer.sample(jax.random.PRNGKey(6), n, jnp.zeros((), jnp.int32), adr=overrides)
    tsample = dr_sample_from_jax({k: np.asarray(v) for k, v in jsample.items()})
    dyn = tenv.pack_dyn(tsample)
    assert {"dof_damping", "dof_stiffness", "dof_friction", "armature", "body_mass", "cpoint_friction",
            "cpoint_restitution"} == set(dyn.names)
    jdyn = jax_dyn(jenv, jsample, dyn.names)
    wb = np.asarray(js.worker_boundary)
    for name, o in overrides.items():  # two envs pinned at the two edges of every physics parameter
        mask = np.asarray(o["pin_mask"])
        assert mask.sum() == 2 and set(wb[mask] % 2) == {0, 1}, name
        v = np.asarray(jsample[name])[mask].reshape(2, -1)
        np.testing.assert_array_equal(v, np.broadcast_to(np.asarray(o["pin_val"])[mask][:, None], v.shape))
    m, p = tenv.model, tenv.sim_params
    tout = tfused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=qt, dyn=dyn)
    jout = jfused.physics_step_fused(jenv.model, jenv.sim_params, *(jnp.asarray(t.numpy()) for t in (q, qd, qfrc)),
                                     xfrc=jnp.asarray(xfrc.numpy()), q_target=jnp.asarray(qt.numpy()), use_pallas=False,
                                     dyn={k: jnp.asarray(v) for k, v in jdyn.items()})
    for k, tol in TOL.items():
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)), atol=tol, err_msg=k)
    force = np.linalg.norm(np.asarray(jout.body_force)[:, tenv.obj_body], axis=-1)
    assert (force > 0.01).mean() >= 0.5, force


# ---- reset and env steps, ADR on ------------------------------------------------------

def _fields(js):
    return {"q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf,
            "actions": js.actions, "task": jax.tree.map(np.asarray, js.task)}


def _put_jax_state(tenv, tstate, js):
    """The port's state holding JAX's: the sim, task, DR sample (its leaves
    packed anew), ADR state and counters."""
    tstate = env_state_from_arrays(tstate, _fields(js), "cpu")
    tstate.dr = dr_sample_from_jax({k: np.asarray(v) for k, v in js.dr.items()})
    tstate.dyn = tenv.pack_dyn(tstate.dr)
    tstate.adr = port_adr(js.adr)
    tstate.randomize_buf = _t(js.randomize_buf, torch.int32)
    tstate.frames = _t(js.frames, torch.int32)
    return tstate


def test_reset_and_env_steps_match_jax():
    """AllegroHandDextremeADR, ADR on, the yaml's domain randomization drawn
    through ADR's overrides: the port's observation of the JAX reset state
    equals the JAX reset's (with the reset's draws); then from the port's
    `contact_states`, put on both, three env steps (two physics calls each)
    of gentle random actions against the JAX step under `jax.jit`, the port
    taking JAX's corruption, goal and kick draws (and the DR action noise,
    which this yaml does not draw): q, qd, observation, reward, done, the
    task state, ADR's state and the extras (`adr_nats`, the critic's
    states), on every env. Each step starts both from the JAX state."""
    jenv, tenv = _both("AllegroHandDextremeADR")
    jstate, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    assert jstate.adr is not None and jstate.dr is not None
    tstate = _put_jax_state(tenv, tenv.reset(0)[0], jstate)
    tenv._draws = jax_corruption_draws(jstate.task)
    obs = tenv.observe(tstate.sim.q, tstate.sim.qd, tenv._kin(tstate.sim.q, tstate.sim.qd), tenv._no_sensors(N),
                       tstate.task, tstate.actions, tstate.progress)
    np.testing.assert_allclose(torch.clamp(obs, -tenv.clip_obs, tenv.clip_obs).numpy(), np.asarray(jobs), atol=1e-5)
    q, qd = tenv.contact_states(N, seed=7)
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q.numpy()), qd=jnp.asarray(qd.numpy())))
    tstate = _put_jax_state(tenv, tstate, jstate)
    rng = np.random.RandomState(8)
    jstep = jax.jit(jenv.step)
    try:
        for k in range(3):
            a = rng.uniform(-0.1, 0.1, (N, 16)).astype(np.float32)
            draws = jax_corruption_draws(jstate.task)
            tenv.corruption_draws = lambda n, d=draws: d
            tenv.draws_of_step = lambda n, t=jstate.task: jax_step_draws(t)
            noised = _t(jenv.randomizer.action_noise(jax.random.split(jstate.rng)[1], jnp.asarray(a), jstate.frames,
                                                     dr_sample=jstate.dr))
            tenv.randomizer.action_noise = lambda g, acts, frames, dr_sample=None, v=noised: v
            jstate, jobs, jrew, jdone, jex = jstep(jstate, jnp.asarray(a))
            tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
            for got, want, tol, name in ((tstate.sim.q, jstate.sim.q, TOL["q"], "q"),
                                         (tstate.sim.qd, jstate.sim.qd, TOL["qd"], "qd"),
                                         (tobs, jobs, 1e-3, "obs"), (trew, jrew, 1e-3, "reward"),
                                         (tex["states"], jex["states"], 2e-2, "states")):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, err_msg=f"{name} {k}")
            np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
            for name in ("goal_rot", "successes", "hold", "targets", "rb_force", "act_hist", "cube_obs", "cube_age",
                         "adr"):
                np.testing.assert_allclose(tstate.task[name].numpy().astype(np.float32),
                                           np.asarray(jstate.task[name], np.float32), atol=1e-4, err_msg=name)
            for f in ("lo", "hi", "queues", "counts", "worker_boundary"):
                np.testing.assert_array_equal(getattr(tstate.adr, f).numpy(), np.asarray(getattr(jstate.adr, f)))
            np.testing.assert_allclose(tex["adr_nats"].numpy(), np.asarray(jex["adr_nats"]), atol=1e-6)
            for name in ("consecutive_successes", "time_outs"):
                np.testing.assert_array_equal(tex[name].numpy(), np.asarray(jex[name]), err_msg=name)
            tstate = _put_jax_state(tenv, tstate, jstate)
    finally:
        for hook in ("corruption_draws", "draws_of_step"):
            tenv.__dict__.pop(hook, None)
        tenv.randomizer.__dict__.pop("action_noise", None)
    assert bool(torch.isfinite(tstate.sim.q).all()) and tobs.shape == (N, 47)


# ---- the yamls and the names ----------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_configs_match_jax(task):
    """`load_config` gives the JAX package's dict (but for the device flags)
    for each DeXtreme yaml with its recipe; the env's dims, episode length
    (resetTime 8 s at controlFrequencyInv 2) and ADR parameters are JAX's."""
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg, jcfg = load_config([f"task={task}"]), jload([f"task={task}"])
    for c in (cfg, jcfg):
        for k in ("sim_device", "rl_device", "device"):
            c.pop(k, None)
    assert cfg == jcfg and cfg["task"]["env"]["numEnvs"] == 8192
    jenv, tenv = _both(task)
    assert (tenv.num_obs, tenv.num_states, tenv.num_acts, tenv.max_episode_length, tenv.control_freq_inv) == \
        (jenv.num_obs, jenv.num_states, jenv.num_acts, jenv.max_episode_length, jenv.control_freq_inv) == \
        (47, 88, 16, 241, 2)
    assert tenv.adr.param_names() == jenv.adr.param_names() and tenv.adr.update_ranges == jenv.adr.update_ranges
    assert tenv.adr.dr_params == jenv.adr.dr_params
    assert tenv.randomizer.batched_leaf_names() == jenv.randomizer.batched_leaf_names()


def test_four_names_load_and_resolve():
    """The four names of the JAX task_map resolve to the same classes in the
    port; the short names load the full names' yamls and recipes."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config

    for short, full in (("AllegroHandADR", "AllegroHandDextremeADR"),
                        ("AllegroHandManualDR", "AllegroHandDextremeManualDR")):
        for name in (short, full):
            assert ttasks[name].__name__ == jtasks[name].__name__ == full
        a, b = load_config([f"task={short}"]), load_config([f"task={full}"])
        assert (a["task_name"], a["train_name"]) == (short, f"{short}PPO")
        assert a["task"] == b["task"] and a["train"] == b["train"]


# ---- tests/test_dextreme.py, the port's counterparts ----------------------------------

def make(name, num_envs=8, adr_override=None, **env_kw):
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={name}", f"num_envs={num_envs}"])["task"]
    cfg["env"].update(env_kw)
    if adr_override is not None:
        cfg["env"]["adr"] = adr_override
    return task_map[name](cfg, device="cpu")


@pytest.mark.parametrize("name", TASKS)
def test_dextreme_contract(name):
    env = make(name)
    assert env.num_obs == 47 and env.num_acts == 16 and env.num_states == 88
    state, obs = env.reset(0)
    assert obs.shape == (8, 47) and state.adr is not None
    for _ in range(3):
        state, obs, rew, done, ex = env.step(state, torch.zeros(8, 16))
    assert bool(torch.isfinite(obs).all()) and ex["states"].shape == (8, 88) and "adr_nats" in ex


def test_action_latency_and_affine():
    env = make("AllegroHandDextremeADR")
    ai = env._ai
    adr = torch.zeros(1, env.adr.P)
    adr[0, ai["action_latency"]] = 2.0
    hist = (torch.arange(1, 17, dtype=torch.float32)[:, None] * torch.ones(16, 16) * 0.01)[None]
    task = {"adr": adr, "act_hist": hist, "bias_action_u": torch.zeros(1, 16),
            "rna_mask": env.rna.sample_mask(torch.Generator().manual_seed(1), 1)}
    d = {"delay_u": torch.ones(1), "act_white": torch.randn(1, 16)}
    q = torch.tensor(np.asarray(env.model.qpos0, np.float32))[None]
    a_now = torch.full((1, 16), 0.5)
    out = env._corrupt_action(a_now, q, task, d)
    # latency 2: the action applied is hist[1] (a_{t-2}), no noise terms
    np.testing.assert_allclose(out.numpy(), hist[:, 1].numpy(), atol=1e-6)
    # a per-episode additive bias shifts the action
    adr2 = adr.clone()
    adr2[0, ai["affine_action_additive"]] = 0.1
    out2 = env._corrupt_action(a_now, q, {**task, "adr": adr2, "bias_action_u": torch.ones(1, 16)}, d)
    np.testing.assert_allclose((out2 - out).numpy(), 0.1, atol=1e-6)


def test_adr_ranges_evolve_through_env_steps():
    """Tiny queues and short episodes: every episode end pushes a boundary
    objective of 0 (below t_low), so the corruption's range narrows, and
    fresh ADR draws land inside it."""
    adr_cfg = {"use_adr": True, "update_adr_ranges": True, "worker_adr_boundary_fraction": 0.9,
               "adr_queue_threshold_length": 2, "adr_objective_threshold_low": 0.5,
               "adr_objective_threshold_high": 2.0,
               "params": {"affine_action_white": {"init_range": [0.0, 0.4], "limits": [0.0, 4.0], "delta": 0.05,
                                                  "delta_style": "additive"}}}
    env = make("AllegroHandDextremeADR", num_envs=64, adr_override=adr_cfg, episodeLength=3, resetTime=-1)
    state, _ = env.reset(0)
    hi0 = float(state.adr.hi[0])
    for _ in range(20):
        state, obs, rew, done, ex = env.step(state, torch.zeros(64, 16))
    assert float(state.adr.hi[0]) < hi0
    assert float(state.task["adr"][:, 0].max()) <= hi0 + 1e-6


def test_camera_sim_latches_cube_pose():
    env = make("AllegroHandDextremeADR")
    state, _ = env.reset(4)
    ai = env._ai
    state.task["adr"][:, ai["cube_pose_refresh_rate"]] = 6.0  # refresh every 6 steps
    state.task["adr"][:, ai["cube_obs_delay_prob"]] = 0.0
    for _ in range(2):
        state, *_ = env.step(state, torch.zeros(8, 16))
    oq = env.obj_q
    assert bool((state.task["cube_age"] >= 1).all())  # the latch holds while the ages advance
    assert not torch.allclose(state.sim.q[:, oq:oq + 7], state.task["cube_obs"], atol=1e-5)


def test_obs_spec_matches_flat_layout():
    from isaacgymenvs_tpu_torch.tasks.allegro_hand_dextreme import AllegroHandDextremeADR

    spec = AllegroHandDextremeADR.OBS_SPEC
    assert sum(spec.values()) == 47
    assert list(spec) == ["dof_pos_randomized", "object_pose_cam_randomized", "goal_pose",
                          "goal_relative_rot_cam_randomized", "last_actions"]
    assert make("AllegroHandDextremeADR", num_envs=2).observation_dict_space == spec


def test_annealed_action_ema_and_latency_cap():
    """actionsMovingAverage's dict anneals from its upper to its lower value
    over schedule_steps; ManualDR's latency cap ramps from 0 to
    actionLatencyMax."""
    env = make("AllegroHandDextremeManualDR", num_envs=2)
    assert env._ma_upper > env._ma_lower
    ma = lambda t: float(env._act_ma({"_frames": torch.tensor(int(t), dtype=torch.int32)}))
    a0, am, ae = ma(0), ma(env._ma_steps // 2), ma(env._ma_steps * 2)
    assert a0 == pytest.approx(env._ma_upper) and ae == pytest.approx(env._ma_lower) and ae < am < a0
    cap = lambda t: int(env._latency_cap({"_frames": torch.tensor(int(t), dtype=torch.int32)}))
    assert cap(0) == 0 and cap(env._lat_sched * 2) == min(int(env._lat_max), 15)


def test_capped_dof_control_limits_target_rate():
    """use_capped_dof_control caps the targets' change per step at
    max_dof_radians_per_second * dt * controlFrequencyInv."""
    env = make("AllegroHandDextremeManualDR", num_envs=2, use_capped_dof_control=True, max_dof_radians_per_second=0.5)
    assert env.use_capped_dof_control
    prev = (0.5 * (env.dof_lower + env.dof_upper)).expand(2, 16)
    tgt = env._targets(prev, torch.ones(2, 16), {"_frames": torch.tensor(0)}, capped=True)
    delta = (tgt - prev).abs()
    assert float(delta.max()) <= 0.5 * env.dt * env.control_freq_inv + 1e-6 and float(delta.max()) > 0
