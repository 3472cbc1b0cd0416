"""The port's FactoryTaskInsertion against the JAX package, on the CPU.

The Franka is the hand-written Panda stand-in
(isaacgymenvs_tpu_torch/assets/urdf/franka_description/robots/franka_panda.urdf),
the plug and socket meshes the stand-ins written by
assets/factory/make_insertion_meshes.py; the JAX package reads them
through $ISAACGYMENVS_TPU_ASSETS. Tolerances: models equal within 1e-6;
`sdf_dyn` within 1e-5; the plain step with SDF rows as tests/test_fused.py
:79-82 (q 2e-4, qd 2e-3, forces 2e-2); env steps q 2e-4, qd 2e-3, obs and
reward exactly zero on both sides.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.engine import _cuda
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root

N = 4
TASK = "FactoryTaskInsertion"
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
FRANKA = os.path.join(package_asset_root(), "urdf", "franka_description", "robots", "franka_panda.urdf")


def _assert_models_equal(a, b):
    """Field by field, floats to 1e-6; tuples of arrays (the SDF grids) entry by entry."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif isinstance(x, np.ndarray):
            y = np.asarray(y)
            assert x.shape == y.shape, f.name
            np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64), atol=1e-6, err_msg=f.name)
        elif isinstance(x, tuple) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y), f.name
            for u, w in zip(x, y):
                np.testing.assert_allclose(u, np.asarray(w), atol=1e-6, err_msg=f.name)
        else:
            assert (tuple(x) == tuple(y)) if isinstance(x, tuple) else x == y, f.name


def _both(extra=()):
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    args = [f"task={TASK}", f"num_envs={N}", *extra]
    jcfg = jload(args)["task"]
    jcfg["sim"]["use_fused"] = True
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks[TASK](jcfg)
        tenv = ttasks[TASK](tload(args)["task"], device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def envs():
    return _both()


def test_franka_stand_in_through_both_parsers():
    """The Panda stand-in through both URDF parsers (fix_base): equal
    models; 12 bodies (panda_link8 and panda_hand on fixed joints), 7
    revolute joints then the 2 prismatic fingers as the last dofs, the
    public limits (mid-range of joint 4 at -1.5708, fingers at 0.02)."""
    from isaacgymenvs_tpu.model import load_urdf as jload_urdf
    from isaacgymenvs_tpu_torch.model import load_urdf

    tm, jm = load_urdf(FRANKA, fix_base=True), jload_urdf(FRANKA, fix_base=True)
    _assert_models_equal(tm, jm)
    assert (tm.nbody, tm.nq, tm.nv) == (12, 9, 9)
    assert tm.jnt_type[1:8] == (1,) * 7 and tm.jnt_type[10:] == (2, 2) and tm.jnt_type[8:10] == (3, 3)
    mid = 0.5 * (tm.dof_limit_lower + tm.dof_limit_upper)
    np.testing.assert_allclose(mid[[3, 5, 7, 8]], [-1.5708, 1.8675, 0.02, 0.02], atol=1e-6)
    assert tm.dof_body[-2:] == (10, 11) and tm.body_names[-2:] == ("panda_leftfinger", "panda_rightfinger")


def test_insertion_model_matches_jax(envs):
    """`compose` of Franka, plug and socket, the stripped candidate points,
    the 64 stratified plug points, the hole's SDF grid and the pairs: every
    leaf of the two models equal; the actor refs equal."""
    jenv, tenv = envs
    _assert_models_equal(tenv.model, jenv.model)
    assert tuple(tenv.plug_ref) == tuple(jenv.plug_ref) and tuple(tenv.socket_ref) == tuple(jenv.socket_ref)
    m = tenv.model
    assert (m.nbody, m.nq, m.nv, m.ncp, len(m.spair_point)) == (14, 16, 15, 64, 64)
    assert set(m.cpoint_body) == {tenv.plug_ref.body0} and m.sdf_body == (tenv.socket_ref.body0,)
    np.testing.assert_array_equal(tenv.q_idx.numpy(), np.asarray(jenv.q_idx))
    np.testing.assert_allclose(tenv.q_mid.numpy(), np.asarray(jenv.q_mid), atol=1e-7)


def test_compose_offsets_every_declaration():
    """`compose` against the JAX `compose` on two copies of a model with a
    point pair, an anchor, a tendon and an SDF pair: the second copy's
    indices are offset (bodies, dofs, points, geoms, grids)."""
    from isaacgymenvs_tpu.model import spec as jspec
    from isaacgymenvs_tpu.model.compose import compose as jcompose
    from isaacgymenvs_tpu.sdf import builder as jsdf
    from isaacgymenvs_tpu_torch.model.compose import compose
    from isaacgymenvs_tpu_torch.model.examples import cube_mesh, tendon_chain_example
    from isaacgymenvs_tpu_torch.sdf import builder as tsdf

    def decorate(m, sdf):
        m = m.replace(att_body=(1,), att_offset=np.ones((1, 3), np.float32), att_target=np.zeros((1, 3), np.float32))
        m, g = sdf.attach_sdf(m, 0, sdf.mesh_to_sdf(*cube_mesh(0.1), resolution=12))
        return sdf.pair_points_with_sdf(m, [0, 1], g)

    tm = decorate(tendon_chain_example(), tsdf)
    jm = decorate(tendon_chain_example(jspec), jsdf)
    tc, trefs = compose([tm, tm], ["a:", "b:"])
    jc, jrefs = jcompose([jm, jm], ["a:", "b:"])
    _assert_models_equal(tc, jc)
    assert [tuple(r) for r in trefs] == [tuple(r) for r in jrefs]
    assert tc.spair_sdf == (0, 0, 1, 1) and tc.spair_point[2:] == (tm.ncp, tm.ncp + 1)
    assert tc.sdf_body == (0, tm.nbody) and tc.tendon_coef.shape == (2, 2 * tm.nv)


def _probe(tenv, jenv, n, seed):
    """Contact states of the port's env and the inputs of their physics
    step: q, qd (numpy), and the port's qfrc, xfrc, q_target."""
    q, qd = tenv.contact_states(n, seed)
    qfrc, xfrc, qt = tenv.compute_force(None, q, qd, {"q_ref": q[:, tenv.q_idx]})
    return q.numpy(), qd.numpy(), qfrc, xfrc, qt


def test_insertion_sdf_dyn_and_plain_step_match_jax(envs):
    """At 4 contact states (plug in the bore, on the socket's top face,
    lying against its side, in the bore): `sdf_dyn` of both within 1e-5;
    the gravity compensation and PD setpoints of both; the plain step with
    SDF rows against JAX `physics_step_fused(use_pallas=False,
    dyn=sdf_dyn(...))`; SDF rows active in every env and the cap of 32
    binding in the env lying against the socket (more than 32 candidates
    active)."""
    from isaacgymenvs_tpu.engine import fused as jfused

    jenv, tenv = envs
    jm, tm = jenv.model, tenv.model
    q, qd, qfrc, xfrc, qt = _probe(tenv, jenv, N, seed=5)
    tdyn = tfused.sdf_dyn(tm, torch.tensor(q), torch.tensor(qd))
    jdyn = jfused.sdf_dyn(jm, jnp.asarray(q), jnp.asarray(qd))
    for k in tfused.SP_KEYS:
        np.testing.assert_allclose(tdyn[k].numpy(), np.asarray(jdyn[k]), atol=1e-5, err_msg=k)
    jq_ref = jnp.asarray(q[:, tenv.q_idx.numpy()])
    jqfrc, jxfrc, jqt = jax.vmap(lambda a, b, r: jenv.compute_force(None, a, b, {"q_ref": r}))(
        jnp.asarray(q), jnp.asarray(qd), jq_ref)
    np.testing.assert_allclose(xfrc.numpy(), np.asarray(jxfrc), atol=1e-5)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(jqt))
    p = tenv.sim_params
    s = tfused.spec_of(tm)
    assert tfused.topk_cap(s, p) == 32 and s.nct == 128
    keys = []
    run = tfused._step_math_torch(s, p, "cpu", (), keys)
    rows = lambda a: a.T.contiguous()
    run(rows(torch.tensor(q)), rows(torch.tensor(qd)), rows(qfrc), xfrc.permute(2, 1, 0).reshape(6 * s.nbody, N),
        rows(qt), None, None, 0, tfused.pack_sdf(tdyn))
    active = keys[0][0] > -p.contact_margin
    assert bool(active[s.nc:].any(0).all())
    assert int((active.sum(0) > 32).sum()) == 1
    tout = tfused.physics_step_fused(tm, p, torch.tensor(q), torch.tensor(qd), qfrc, xfrc=xfrc, q_target=qt,
                                     dyn=tdyn)
    jout = jfused.physics_step_fused(jm, jenv.sim_params, jnp.asarray(q), jnp.asarray(qd), jqfrc, xfrc=jxfrc,
                                     q_target=jqt, use_pallas=False, dyn=jdyn)
    for k, tol in TOL.items():
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)), atol=tol, err_msg=k)
    plug = tenv.plug_ref.body0
    assert (np.abs(np.asarray(jout.body_force)[:, plug, 2]) > 0.1).all()


def _port_state(tenv, jstate):
    st, _ = tenv.reset(0)
    t = lambda a: torch.tensor(np.asarray(a))
    st.sim = SimState(q=t(jstate.sim.q), qd=t(jstate.sim.qd))
    st.progress = t(jstate.progress).to(torch.int32)
    st.reset_buf = t(jstate.reset_buf)
    st.actions = t(jstate.actions)
    st.task = {k: t(v) for k, v in jstate.task.items()}
    return st


def test_insertion_env_steps_match_jax(envs):
    """Reset and 3 env steps of both under the same random actions (which
    the template stores and never applies), from the JAX reset state put on
    the port's state: q 2e-4, qd 2e-3; observations and rewards zero; done
    flags and progress equal."""
    jenv, tenv = envs
    jstate, jobs = jenv.reset(jax.random.PRNGKey(0))
    tstate = _port_state(tenv, jstate)
    rng = np.random.RandomState(2)
    for _ in range(3):
        a = rng.uniform(-1, 1, (N, 12)).astype(np.float32)
        jstate, jobs, jrew, jdone, _ = jenv.step(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        assert not tobs.any() and not trew.any() and not np.asarray(jobs).any() and not np.asarray(jrew).any()
        np.testing.assert_allclose(tstate.sim.q.numpy(), np.asarray(jstate.sim.q), atol=2e-4)
        np.testing.assert_allclose(tstate.sim.qd.numpy(), np.asarray(jstate.sim.qd), atol=2e-3)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tstate.progress.numpy(), np.asarray(jstate.progress))
        assert tobs.shape == (N, 32)


def test_template_contract(envs):
    """tests/test_factory_templates.py:18-59 on the port: zero observation
    and reward over 20 steps of random actions, finite state, the arm
    within 0.2 rad of its reset pose, the plug's contact points above -5 mm."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine import dynamics

    _, env = envs
    assert env.num_obs == 32 and env.num_acts == 12
    state, obs = env.reset(0)
    assert obs.shape == (N, 32) and not obs.any()
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        state, obs, rew, done, _ = env.step(state, torch.rand(N, 12, generator=gen) - 0.5)
    assert not obs.any() and not rew.any()
    q, qd = state.sim.q, state.sim.qd
    assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(qd).all())
    assert float((q[:, env.q_idx] - state.task["q_ref"]).abs().max()) < 0.2
    m, plug = env.model, env.plug_ref.body0
    kin = dynamics.forward_kinematics(m, q, torch.zeros_like(qd))
    pts = kin.x[:, plug:plug + 1] + maths.quat_rotate(kin.quat[:, plug:plug + 1].expand(N, m.ncp, 4),
                                                      torch.tensor(m.cpoint_pos).expand(N, m.ncp, 3))
    assert float(pts[..., 2].min()) > -0.005


def test_insertion_fits_two_envs_per_block_and_an_oversized_model_is_refused(envs):
    """Insertion's block: its per-env floats as the kernel lays them out (J
    for the cap's 32 slots only, W nowhere, the articulated work in the same
    floats: 3,812, once 15,592), so 8 envs fit one block, and 8 per block
    keeps the most envs resident per SM (one block of 8 warps; 2 per block,
    the one choice before W went, fits too).
    The same model with enough further SDF pair rows does not fit at one env
    per block: `unsupported_features` names the limit with the byte count,
    and the step refuses it before any launch."""
    _, env = envs
    m, p = env.model, env.sim_params
    s = tfused.spec_of(m)
    assert _cuda.env_floats(s, True, (), 32) == 3812
    smem = {e: _cuda.smem_bytes(s, p, e, has_qt=True) for e in (8, 4, 2, 1)}
    assert smem[8] <= _cuda.SMEM_OPTIN_BYTES and smem[2] <= _cuda.SMEM_OPTIN_BYTES
    assert _cuda.envs_per_block(lambda e: smem[e], _cuda.SMEM_OPTIN_BYTES, _cuda.plan_regs(s.nv)) == 8
    assert tfused.unsupported_features(m, p) == []
    from isaacgymenvs_tpu_torch.sdf.builder import add_contact_points, pair_points_with_sdf

    big = m
    while True:
        big, cp = add_contact_points(big, env.plug_ref.body0, np.asarray(m.cpoint_pos)[:64], friction=0.5)
        big = pair_points_with_sdf(big, cp, 0)
        need = _cuda.smem_bytes(tfused._extract(big), p, 1)
        if need > _cuda.SMEM_OPTIN_BYTES:
            break
    named = tfused.unsupported_features(big, p)
    assert named == [f"shared memory: {need} bytes per block at one env per block, over the "
                     f"{_cuda.SMEM_OPTIN_BYTES}-byte limit of one block on the H100"]
    q = torch.tensor(m.qpos0)[None]
    with pytest.raises(NotImplementedError, match="shared memory"):
        tfused.physics_step_fused(big, p, q, torch.zeros(1, m.nv), torch.zeros(1, m.nv),
                                  sdf=torch.zeros(13 * tfused._extract(big).sp_n, 1))
