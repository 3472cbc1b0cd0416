"""The port's eager engine against the JAX package's, on the CPU: the
narrowphase, the dynamics (engine/dynamics.py) and the constraint rows of
each source (engine/contacts.py).

Inputs come from a numpy seed and go through both packages; the cases, the
vmapped JAX side and the tolerances are tests/torch_eager_cases.py's
(single functions at rtol 1e-5, M^-1 and qdd at 1e-4). The solve, the body
wrenches and whole steps are tests/test_torch_engine_eager_steps.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.engine import contacts as jcon
from isaacgymenvs_tpu.engine import dynamics as jdyn
from isaacgymenvs_tpu.engine.step import _masks
from isaacgymenvs_tpu_torch.engine import contacts as tcon
from isaacgymenvs_tpu_torch.engine import dynamics as tdyn
from isaacgymenvs_tpu_torch.model.spec import GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from torch_eager_cases import (ALL_LEAVES, CASES, INV_RTOL, N, case, close, jax_rows, jax_vmap, jmodel, jparams,
                               leaves_of, terrains)

torch.set_num_threads(1)


# ---- narrowphase ----------------------------------------------------------------------------------------


@pytest.mark.parametrize("gtype", [GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX, GEOM_CYLINDER, 5])
def test_sphere_vs_geom_matches_jax(gtype):
    """`_sphere_vs_geom` on 64 spheres per env (N envs, each its own geom
    pose and size) around and inside the geom: phi, normal and point
    against JAX's vmapped per sphere; a mesh geom (type 5) takes the
    cylinder branch in both."""
    rng = np.random.RandomState(gtype)
    k = 64
    size = rng.uniform(0.1, 0.3, (N, 1, 3)).astype(np.float32)
    gpos = rng.uniform(-0.2, 0.2, (N, 1, 3)).astype(np.float32)
    quat = rng.normal(size=(N, 1, 4))
    gquat = (quat / np.linalg.norm(quat, axis=-1, keepdims=True)).astype(np.float32)
    center = (gpos + rng.uniform(-0.45, 0.45, (N, k, 3))).astype(np.float32)
    radius = rng.uniform(0.01, 0.05, (N, k)).astype(np.float32)
    phi, n, x = tcon._sphere_vs_geom(*(torch.tensor(a) for a in (center, radius)), gtype,
                                     *(torch.tensor(a) for a in (gpos, gquat, size)))
    one = lambda c, r, p, qq, s: jcon._sphere_vs_geom(c, r, gtype, p, qq, s)
    jf = jax.vmap(jax.vmap(one, in_axes=(0, 0, None, None, None)), in_axes=(0, 0, 0, 0, 0))
    jphi, jn, jx = jf(*(jnp.asarray(a) for a in (center, radius, gpos[:, 0], gquat[:, 0], size[:, 0])))
    close(phi, jphi, "phi")
    close(n, jn, "normal")
    close(x, jx, "point")


# ---- dynamics -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tendon", "tendon+leaves", "anchors", "terrain"])
def test_dynamics_match_jax(name):
    """FK, `bias_force` (with an external wrench and gravity), `passive_force`
    (tendon, joint friction, limits, a `q_spring` setpoint), `forward_dynamics`
    (qdd and M^-1 through minv_mul) and `integrate_positions` against JAX's
    vmapped; "+leaves" with every per-env leaf and per-env gravity."""
    tm, p, q, qd, _ = case(name.split("+")[0])
    jm = jmodel(tm)
    lv, tlv = leaves_of(tm, ALL_LEAVES, 5) if name.endswith("+leaves") else ({}, None)
    rng = np.random.RandomState(7)
    qfrc = rng.uniform(-1, 1, (N, tm.nv)).astype(np.float32)
    xfrc = rng.uniform(-1, 1, (N, tm.nbody, 6)).astype(np.float32)
    q_spring = (q + rng.uniform(-0.05, 0.05, q.shape)).astype(np.float32)
    h = p.dt / p.substeps
    grav = lv.get("gravity", np.tile(np.asarray(p.gravity, np.float32), (N, 1)))

    def jfn(m, jp, q_, qd_, tau, fe, qs, g):
        masks, sq, meta = _masks(m)
        kin = jdyn.forward_kinematics(m, q_, qd_, meta)
        C = jdyn.bias_force(m, kin, qd_, g, fe, masks)
        tp, D, K = jdyn.passive_force(m, q_, qd_, jp, sq, qs)
        qdd, minv_mul, _ = jdyn.forward_dynamics(m, q_, qd_, tau, fe, jp, masks, sq, kin=kin, h=h, q_spring=qs)
        q2 = jdyn.integrate_positions(m, q_, qd_ + h * qdd, h, meta)
        return kin, C, (tp, D, K), qdd, minv_mul(jnp.eye(m.nv)), q2

    jout = jax_vmap(jfn, jm, jparams(p), lv)(*(jnp.asarray(a) for a in (q, qd, qfrc, xfrc, q_spring, grav)))
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    meta = tdyn.engine_meta(tm, "cpu")
    masks = (meta.anc, meta.dof_mask)
    kin = tdyn.forward_kinematics(tm, tq, tqd, tlv)
    C = tdyn.bias_force(tm, kin, tqd, torch.tensor(grav), torch.tensor(xfrc), masks, tlv)
    tp = tdyn.passive_force(tm, tq, tqd, p, meta.sq_adr, torch.tensor(q_spring), tlv)
    qdd, minv_mul, _ = tdyn.forward_dynamics(tm, tq, tqd, torch.tensor(qfrc), torch.tensor(xfrc), p, masks,
                                             meta.sq_adr, kin=kin, h=h, q_spring=torch.tensor(q_spring), leaves=tlv)
    q2 = tdyn.integrate_positions(tm, tq, tqd + h * qdd, h, meta)
    for f in kin._fields:
        close(getattr(kin, f), getattr(jout[0], f), f"kin.{f}")
    close(C, jout[1], "bias_force")
    for a, b, what in zip(tp, jout[2], ("tau_passive", "D", "K")):
        close(a.expand(b.shape), b, what)
    # the outputs of an inverse: two libraries' float32 Cholesky factorizations part by about cond(M) eps
    close(minv_mul(torch.eye(tm.nv).expand(N, -1, -1)), jout[4], "M^-1", rtol=INV_RTOL)
    close(qdd, jout[3], "qdd", rtol=INV_RTOL)
    close(q2, jout[5], "integrate_positions")
    if name == "tendon":
        assert tm.tendon_coef.shape[0] == 1 and tm.dof_friction is not None


@pytest.mark.parametrize("name", CASES)
def test_constraint_data_matches_jax(name):
    """`constraint_data` for each source of rows (plane with restitution and
    point-vs-box pairs: tendon; point pairs against a box and a sphere:
    pair; geom-geom pairs; an SDF grid; anchors with a point-vs-cylinder
    pair: BallBalance; a heightfield: the Ant) against JAX's vmapped: the
    Jacobian, depths, anchor errors, frictions, frames, points,
    restitutions and the static body lists."""
    tm, p, q, qd, terr = case(name)
    tt, jt = terrains(terr)
    kin_j, jc, _, _ = jax_rows(jmodel(tm), jparams(p), q, qd, jt)
    meta = tdyn.engine_meta(tm, "cpu")
    kin = tdyn.forward_kinematics(tm, torch.tensor(q), torch.tensor(qd))
    tc = tcon.constraint_data(tm, kin, meta.anc, terrain=tt)
    assert tc.J.shape[1] == tcon.num_constraints(tm) == jcon.num_constraints(tm) > 0
    for f in ("J", "phi", "err", "mu", "bilateral", "x", "frame", "rest"):
        close(getattr(tc, f), getattr(jc, f), f)
    assert bool(tc.active.all()) and bool(np.asarray(jc.active).all())
    np.testing.assert_array_equal(tc.body_a, np.asarray(jc.body_a)[0])
    np.testing.assert_array_equal(tc.body_b, np.asarray(jc.body_b)[0])
    assert bool((tc.phi > -p.contact_margin).any())  # some row acts
