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
