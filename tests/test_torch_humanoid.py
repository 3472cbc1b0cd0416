"""The port's Humanoid against the JAX package: the hand-written model
(`assets/mjcf/nv_humanoid.xml`) through both MJCF parsers, and the task's
reset and step from the same state.

The JAX step runs op by op (not under jit) with its fused physics math, as
in tests/test_torch_env.py: its potentials lie near 6e4 and jit would
round the reward differently. The forces are compared directly, the port
step's physics call (recorded where the env makes it) against the JAX
package's fused step on the same inputs, and through the observation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 4
CFG = {"env": {"numEnvs": N, "clipActions": 1.0}, "sim": {"dt": 0.0166, "substeps": 2}}
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}


@pytest.fixture(scope="module")
def envs():
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Humanoid"]({"env": dict(CFG["env"]), "sim": {**CFG["sim"], "use_fused": True}})
        tenv = ttasks["Humanoid"]({k: dict(v) for k, v in CFG.items()}, device="cpu")
    return jenv, tenv


def test_model_matches_jax(envs):
    """Every field of the parsed model equal within 1e-6, and the facts
    tests/test_model.py:72-89 pins: nv 27, nu 21, a free root, `__f`
    links, abdomen_z stiffness 20 and armature 0.02, right_knee stiffness
    5, a total mass in (30, 120) kg; two foot bodies, 35 candidates."""
    from isaacgymenvs_tpu_torch.model.spec import FREE, Model

    jm, tm = envs[0].model, envs[1].model
    for f in dataclasses.fields(Model):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if a is None or isinstance(a, (bool, int, str)) or (isinstance(a, tuple) and not any(
                hasattr(x, "shape") for x in a)):
            assert a == b or tuple(a) == tuple(b), f.name
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=1e-6,
                                       err_msg=f.name)
    assert (tm.nv, tm.nu, tm.nq, tm.nbody, tm.ncp) == (27, 21, 28, 25, 35)
    assert tm.jnt_type[0] == FREE and sum("__f" in n for n in tm.body_names) == 9
    names = tm.dof_joint_names()
    assert float(tm.dof_stiffness[names.index("abdomen_z")]) == pytest.approx(20.0)
    assert float(tm.armature[names.index("abdomen_z")]) == pytest.approx(0.02)
    assert float(tm.dof_stiffness[names.index("right_knee")]) == pytest.approx(5.0)
    assert 30.0 < float(np.sum(tm.body_mass)) < 120.0
    assert [tm.body_names[i] for i in envs[1].feet.tolist()] == ["right_foot", "left_foot"]


def _port_state(tenv, jstate, q=None, qd=None):
    st, _ = tenv.reset(0)
    t = lambda a: torch.tensor(np.asarray(a))
    st.sim = SimState(q=t(jstate.sim.q) if q is None else q, qd=t(jstate.sim.qd) if qd is None else qd)
    st.progress = t(jstate.progress).to(torch.int32)
    st.reset_buf = t(jstate.reset_buf)
    st.actions = t(jstate.actions)
    st.task = tuple(t(x) for x in jstate.task)
    return st


def test_reset_matches_jax(envs):
    """The port's observation of the JAX reset state equals the JAX reset's
    (atol 1e-4; sensors zero); the port's own reset draws the reference's
    ranges: torso at 1.34, dofs within 0.2 of the start pose and the limits,
    velocities within 0.1, potentials -|to_target| / dt near 6e4."""
    jenv, tenv = envs
    jstate, jobs = jenv.reset(jax.random.PRNGKey(0))
    st = _port_state(tenv, jstate)
    obs = tenv.observe(st.sim.q, st.sim.qd, None, tenv._no_sensors(N), st.task, st.actions, st.progress)
    np.testing.assert_allclose(torch.clamp(obs, -tenv.clip_obs, tenv.clip_obs).numpy(), np.asarray(jobs), atol=1e-4)
    for a, b in zip(st.task, jstate.task):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    own, obs = tenv.reset(3)
    q, qd = own.sim.q, own.sim.qd
    assert obs.shape == (N, 108) and torch.all(q[:, 2] == 1.34)
    dof = q[:, tenv.dof_q_idx]
    lo = torch.clamp(tenv.initial_dof_pos - 0.2, tenv.dof_lower, tenv.dof_upper)
    hi = torch.clamp(tenv.initial_dof_pos + 0.2, tenv.dof_lower, tenv.dof_upper)
    assert torch.all(dof >= lo - 1e-6) and torch.all(dof <= hi + 1e-6)
    assert torch.all(qd[:, tenv.dof_idx].abs() <= 0.1) and torch.all(qd[:, :6] == 0)
    assert torch.allclose(own.task[0], torch.full((N,), -1000.0 / tenv.dt), rtol=1e-6)


def _recorder(mp, module, sink):
    orig = module.physics_step_fused

    def record(*a, **k):
        out = orig(*a, **k)
        sink.append(out)
        return out

    mp.setattr(module, "physics_step_fused", record)


def test_step_matches_jax(envs):
    """Three env steps from standing states (both feet 0-1 mm in the ground)
    under small random actions (at 0.5 of the gear a foot lifts in the first
    step) against the JAX step under `jax.jit`: q 2e-4, qd 2e-3,
    observation and reward 2e-2, done and the time-outs equal. The forces of
    the port step's first physics call against the JAX package's fused
    step on the same inputs: 2e-2, both feet carrying force."""
    from isaacgymenvs_tpu.engine import fused as jfused
    from isaacgymenvs_tpu_torch.engine import fused as tfused

    jenv, tenv = envs
    jstate, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(1))
    q, qd = tenv.standing_states(N, seed=2)
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q.numpy()), qd=jnp.asarray(qd.numpy())))
    tstate = _port_state(tenv, jstate)
    rng = np.random.RandomState(4)
    tout = []
    jstep = jax.jit(jenv.step)
    with pytest.MonkeyPatch.context() as mp:
        _recorder(mp, tfused, tout)
        for k in range(3):
            a = rng.uniform(-0.05, 0.05, (N, 21)).astype(np.float32)
            if k == 0:
                qfrc = jax.vmap(jenv.qfrc_from_actuators)(jnp.asarray(a) * jenv.power_scale)
                jphys = jfused.physics_step_fused(jenv.model, jenv.sim_params, jstate.sim.q, jstate.sim.qd, qfrc,
                                                  xfrc=jnp.zeros((N, jenv.model.nbody, 6)), use_pallas=False)
            jstate, jobs, jrew, jdone, jex = jstep(jstate, jnp.asarray(a))
            tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
            if k == 0:
                for f, tol in TOL.items():
                    np.testing.assert_allclose(getattr(tout[0], f).numpy(), np.asarray(getattr(jphys, f)), atol=tol,
                                               err_msg=f)
                feet_fz = tout[0].body_force[:, tenv.feet, 2]
                assert bool((feet_fz > 1.0).all()), feet_fz
            np.testing.assert_allclose(tstate.sim.q.numpy(), np.asarray(jstate.sim.q), atol=TOL["q"])
            np.testing.assert_allclose(tstate.sim.qd.numpy(), np.asarray(jstate.sim.qd), atol=TOL["qd"])
            np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=2e-2, err_msg=f"step {k} obs")
            np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-2, err_msg=f"step {k} reward")
            np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
            np.testing.assert_array_equal(tex["time_outs"].numpy(), np.asarray(jex["time_outs"]))
    assert len(tout) == 3 and tobs.shape == (N, 108)


def test_standing_states_put_both_feet_on_the_ground(envs):
    """`standing_states`: the lowest foot point 0-1 mm into the ground, both
    feet within 1 mm of it, every joint 0.02 rad inside its limits."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics

    tenv = envs[1]
    m = tenv.model
    q, qd = tenv.standing_states(16, seed=0)
    kin = forward_kinematics(m, q, qd)
    cb = np.asarray(m.cpoint_body)
    x = kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], torch.tensor(np.asarray(m.cpoint_pos)))
    gap = x[..., 2] - torch.tensor(np.asarray(m.cpoint_radius))
    foot_low = torch.stack([gap[:, np.isin(cb, [f])].amin(1) for f in tenv.feet.tolist()], 1)
    assert bool((foot_low.amin(1) <= 0).all()) and bool((foot_low.amin(1) >= -1e-3 - 1e-6).all())
    assert float((foot_low[:, 0] - foot_low[:, 1]).abs().max()) < 1e-3
    assert bool((gap[:, ~np.isin(cb, tenv.feet.tolist())] > 0.05).all())  # nothing else touches
    dof = q[:, tenv.dof_q_idx]
    assert bool((dof >= tenv.dof_lower + 0.02 - 1e-6).all()) and bool((dof <= tenv.dof_upper - 0.02 + 1e-6).all())
    assert float(qd.abs().max()) <= 0.01
