"""The port's eager engine against the JAX package's, on the CPU: the
contact solve and the body wrenches (engine/contacts.py), whole steps
(engine/step.py), and the behaviours of the JAX package's
tests/test_contacts.py:79-184 on the port (anchors hold the feet, the
restitution bounce, joint friction holds small torques).

The solve and the body wrenches take the same inputs on both sides (the JAX
constraint rows and M^-1, carried across) and are held at rtol 1e-5
(`close`); whole steps at the tolerances of tests/test_fused.py:79-82 (q
2e-4, qd 2e-3, forces 2e-2). Cases: tests/torch_eager_cases.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.engine import SimState as JSimState
from isaacgymenvs_tpu.engine import contacts as jcon
from isaacgymenvs_tpu.engine import physics_step as jphysics_step
from isaacgymenvs_tpu_torch.engine import contacts as tcon
from isaacgymenvs_tpu_torch.engine import dynamics as tdyn
from isaacgymenvs_tpu_torch.engine import physics_step
from isaacgymenvs_tpu_torch.engine.dynamics import SimParams, SimState
from isaacgymenvs_tpu_torch.model.spec import GEOM_SPHERE
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from torch_eager_cases import (ALL_LEAVES, N, TOL, case, close, jax_rows, jax_vmap, jmodel, jparams, leaves_of,
                               terrains)

torch.set_num_threads(1)


# ---- the solve and the body wrenches, from the same inputs ------------------------------------------------

SOLVES = {  # case -> (model case, SimParams changes, a warm start)
    "apgd": ("tendon", {}, False),
    "apgd_warm": ("tendon", {}, True),
    "apgd_cap": ("pair", {"max_active_contacts": 6}, True),
    "restitution": ("tendon", {}, False),
    "anchors": ("anchors", {}, True),
    "geom_pair_cap": ("geom_pair", {"max_active_contacts": 5}, False),
    "pgs": ("pair", {"solver": "pgs"}, False),
}


def _port_rows(jc, tm):
    t = lambda a: torch.tensor(np.asarray(a))
    return tcon.ConstraintData(J=t(jc.J), phi=t(jc.phi), err=t(jc.err), mu=t(jc.mu), bilateral=t(jc.bilateral),
                               active=t(jc.active), x=t(jc.x), frame=t(jc.frame), rest=t(jc.rest),
                               body_a=np.asarray(jc.body_a)[0], body_b=np.asarray(jc.body_b)[0])


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_contacts_matches_jax(name):
    """`solve_contacts` on JAX's constraint rows, M^-1 and free velocity,
    on both sides: APGD with and without a cap, warm-started (from random
    impulses), with restitution (the box falling at 1 m/s on its corners of
    restitution 0.5), with anchors, and PGS: the corrected velocity,
    impulses and generalized impulse against JAX's vmapped; then
    `accumulate_body_wrench` on JAX's solve on both sides."""
    base, changes, warm = SOLVES[name]
    tm, p, q, qd, _ = case(base)
    p = dataclasses.replace(p, **changes)
    if name == "restitution":
        qd = qd.copy()
        qd[:, 2] = -1.0  # the box's z velocity
    jm, jp = jmodel(tm), jparams(p)
    kin_j, jc, minv, qd_free = jax_rows(jm, jp, q, qd, None)
    h = p.dt / p.substeps
    nc = jc.phi.shape[1]
    w = np.random.RandomState(11).uniform(0.0, 0.05, (N, nc, 3)).astype(np.float32) if warm else None
    ba, bb = np.asarray(jc.body_a)[0], np.asarray(jc.body_b)[0]

    def jsolve(m, p_, con_arrays, minv_, qdf, warm_, kin_):
        con = jcon.ConstraintData(*con_arrays, body_a=ba, body_b=bb)
        out = jcon.solve_contacts(m, con, lambda r: minv_ @ r, qdf, h, p_, warm=warm_)
        return out, jcon.accumulate_body_wrench(m, con, out, kin_, h)

    arrays = tuple(getattr(jc, f) for f in jcon.ConstraintData._fields[:-2])
    jout, jwrench = jax_vmap(jsolve, jm, jp)(arrays, minv, qd_free, jnp.zeros((N, nc, 3)) if w is None else
                                             jnp.asarray(w), kin_j)
    tc = _port_rows(jc, tm)
    tminv = torch.tensor(np.asarray(minv))
    out = tcon.solve_contacts(tm, tc, lambda r: tminv @ r, torch.tensor(np.asarray(qd_free)), h, p,
                              warm=torch.zeros(N, nc, 3) if w is None else torch.tensor(w))
    for f in ("qd", "impulse", "qfrc"):
        close(getattr(out, f), getattr(jout, f), f)
    kin = tdyn.Kin(*(torch.tensor(np.asarray(a)) for a in kin_j))
    jsol = tcon.SolveOut(*(torch.tensor(np.asarray(a)) for a in jout))
    force, torque = tcon.accumulate_body_wrench(tm, tc, jsol, kin, h)
    close(force, jwrench[0], "body_force")
    close(torque, jwrench[1], "body_torque")
    assert float(out.impulse.abs().max()) > 0
    if name == "restitution":  # the corners bounce: the box's z velocity turns upward
        assert float(out.qd[:, 2].min()) > 0.1
    if "cap" in name:  # the cap binds: more rows in the margin than slots
        assert int(((tc.phi > -p.contact_margin).sum(1) > p.max_active_contacts).sum()) >= 1


# ---- whole steps ------------------------------------------------------------------------------------------

STEPS = {  # case -> (model case, SimParams changes, per-env leaves)
    "tendon": ("tendon", {}, ()),
    "tendon+leaves": ("tendon", {}, ALL_LEAVES),
    "geom_pair+cap": ("geom_pair", {"max_active_contacts": 5}, ()),
    "pgs": ("pair", {"solver": "pgs"}, ()),
    "sdf": ("sdf", {}, ("body_mass", "cpoint_pos", "gravity")),
    "anchors": ("anchors", {}, ()),
    "terrain": ("terrain", {}, ()),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_physics_step_matches_jax(name):
    """Three `physics_step`s (two slices each, the warm start carried across
    slices) of the port against JAX's vmapped, each from the JAX state, with
    applied forces, an external wrench and PD setpoints; per-env leaves and
    gravity where the case names them: q, qd and the last slice's body
    force, torque and generalized contact force."""
    base, changes, names = STEPS[name]
    tm, p, q, qd, terr = case(base)
    p = dataclasses.replace(p, **changes)
    tt, jt = terrains(terr)
    lv, tlv = leaves_of(tm, names, 9) if names else ({}, None)
    jm, jp = jmodel(tm), jparams(p)
    rng = np.random.RandomState(13)
    qfrc = rng.uniform(-0.5, 0.5, (N, tm.nv)).astype(np.float32)
    xfrc = rng.uniform(-0.2, 0.2, (N, tm.nbody, 6)).astype(np.float32)
    qt = (q + rng.uniform(-0.02, 0.02, q.shape)).astype(np.float32)

    def jfn(m, p_, q_, qd_, f, x, t):
        return jphysics_step(m, JSimState(q=q_, qd=qd_), f, p_, xfrc=x, q_target=t, terrain=jt)

    jstep = jax.jit(jax_vmap(jfn, jm, jp, lv))
    acted = 0.0
    for _ in range(3):
        jo = jstep(*(jnp.asarray(a) for a in (q, qd, qfrc, xfrc, qt)))
        to = physics_step(tm, SimState(torch.tensor(q), torch.tensor(qd)), torch.tensor(qfrc), p,
                          xfrc=torch.tensor(xfrc), q_target=torch.tensor(qt), terrain=tt, leaves=tlv)
        for k, tol in TOL.items():
            port = (to.state if k in ("q", "qd") else to)
            port = getattr(port, k).numpy()
            ref = np.asarray(getattr(jo.state if k in ("q", "qd") else jo, k))
            err = float(np.abs(port - ref).max())
            assert err < tol, (name, k, err)
        acted = max(acted, float(np.abs(np.asarray(jo.body_force)).max()))
        q, qd = np.asarray(jo.state.q), np.asarray(jo.state.qd)
    assert acted > 0.1  # contact forces acted


# ---- the behaviours of tests/test_contacts.py:79-184 on the port ------------------------------------------


def test_ball_balance_anchors_hold_feet():
    """BallBalance on the eager route (sim.use_fused=False), 60 steps under
    zero actions: the lower-leg tips stay within 2 cm of their anchors."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.tasks import task_map

    cfg = {"env": {"numEnvs": 2, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2, "use_fused": False}}
    env = task_map["BallBalance"](cfg, device="cpu")
    assert env.physics_route == "eager"
    state, _ = env.reset(0)
    for _ in range(60):
        state, *_ = env.step(state, torch.zeros(2, 3))
    m = env.model
    kin = tdyn.forward_kinematics(m, state.sim.q, state.sim.qd)
    b = np.asarray(m.att_body)
    feet = kin.x[:, b] + maths.quat_rotate(kin.quat[:, b], torch.tensor(m.att_offset))
    err = (feet - torch.tensor(m.att_target)).abs().max()
    assert float(err) < 0.02, float(err)


def _ball(e):
    from isaacgymenvs_tpu_torch.model.spec import FREE, ModelBuilder
    from isaacgymenvs_tpu_torch.sdf.builder import add_contact_points

    b = ModelBuilder()
    body = b.add_body(parent=-1, name="ball", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FREE, mass=1.0,
                      inertia=np.eye(3) * 1e-3)
    b.qpos0_free[body] = (np.array([0, 0, 1.0], np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(body, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (0.1, 0, 0), 0.5)
    m = b.finalize()
    m, idx = add_contact_points(m, body, np.array([[0.0, 0.0, -0.1]], np.float32), friction=0.5)
    rest = np.zeros(m.ncp, np.float32)
    rest[idx[0]] = e
    return m.replace(cpoint_restitution=rest)


def test_restitution_bounce():
    """A ball falling at 3 m/s with restitution 0.8 on its contact point
    bounces back above 1.8 m/s; with 0 it stays below 0.4 m/s."""

    def drop(e):
        m = _ball(e)
        p = SimParams(dt=1 / 120, substeps=2, baumgarte_erp=0.1)
        q = torch.tensor(m.qpos0)[None]
        qd = torch.zeros(1, m.nv)
        qd[0, 2] = -3.0
        vmax = 0.0
        for _ in range(30):
            out = physics_step(m, SimState(q, qd), torch.zeros(1, m.nv), p)
            q, qd = out.state.q, out.state.qd
            vmax = max(vmax, float(qd[0, 2]))
        return vmax

    assert drop(0.8) > 1.8
    assert drop(0.0) < 0.4


def test_dof_friction_holds_small_torques():
    """A horizontal hinge rod under about 1 N m of gravity torque: joint
    friction of 5 N m holds it within 0.08 rad over 60 steps; without
    friction it swings past 0.5 rad."""
    from isaacgymenvs_tpu_torch.model.spec import HINGE, ModelBuilder

    def run(fric):
        b = ModelBuilder()
        rod = b.add_body(parent=-1, name="rod", pos=(0, 0, 1.0), quat=(0, 0, 0, 1), jnt_type=HINGE,
                         jnt_axis=(0, 1, 0), joint_name="hinge", mass=1.0, ipos=(0.1, 0, 0),
                         inertia=np.eye(3) * 1e-2)
        b.add_geom(rod, GEOM_SPHERE, (0.1, 0, 0), (0, 0, 0, 1), (0.02, 0, 0), 0.5)
        m = b.finalize()
        m = m.replace(dof_friction=np.full(m.nv, fric, np.float32))
        p = SimParams(dt=1 / 60, substeps=2)
        q, qd = torch.tensor(m.qpos0)[None], torch.zeros(1, m.nv)
        amax = 0.0
        for _ in range(60):
            out = physics_step(m, SimState(q, qd), torch.zeros(1, m.nv), p)
            q, qd = out.state.q, out.state.qd
            amax = max(amax, abs(float(q[0, 0])))
        return amax

    assert run(5.0) < 0.08
    assert run(0.0) > 0.5


def test_two_eager_steps_from_one_state_are_bit_equal():
    """Determinism: the same step twice from one state gives the same bits
    (the per-body sums are one-hot products, not index_add_)."""
    tm, p, q, qd, _ = case("pair")
    args = (tm, SimState(torch.tensor(q), torch.tensor(qd)), torch.zeros(N, tm.nv), p)
    a, b = physics_step(*args), physics_step(*args)
    for x, y in ((a.state.q, b.state.q), (a.state.qd, b.state.qd), (a.body_force, b.body_force)):
        assert torch.equal(x, y)
