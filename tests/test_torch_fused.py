"""The port's fused physics step against the JAX fused math.

On the CPU `physics_step_fused` runs the plain PyTorch version
(`_step_math_torch`); the reference is the JAX
`physics_step_fused(..., use_pallas=False)`. Tolerances are those of
tests/test_fused.py (q 2e-4, qd 2e-3, forces 2e-2). The kernel itself is
held against the plain version on the card by tests/test_torch_kernel.py
and chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.engine import SimParams as JSimParams
from isaacgymenvs_tpu.engine import fused as jfused
from isaacgymenvs_tpu.model.spec import FREE, GEOM_SPHERE, ModelBuilder
from isaacgymenvs_tpu.sdf.builder import add_contact_points
from isaacgymenvs_tpu_torch.convert import model_from_arrays
from isaacgymenvs_tpu_torch.engine import _cuda
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
CFG = {"env": {"numEnvs": 4, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}


def _jax_fields(m):
    return {f.name: (np.asarray(getattr(m, f.name)) if hasattr(getattr(m, f.name), "shape")
                     else getattr(m, f.name)) for f in dataclasses.fields(m)}


@pytest.fixture(scope="module")
def ant():
    """JAX Ant env and the port's Ant, both reading the bundled MJCF."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Ant"]({k: dict(v) for k, v in CFG.items()})
        tenv = ttasks["Ant"]({k: dict(v) for k, v in CFG.items()}, device="cpu")
    state, _ = jenv.reset(jax.random.PRNGKey(0))
    return jenv, tenv, np.asarray(state.sim.q), np.asarray(state.sim.qd)


def _compare(jm, jp, tm, tp, q, qd, qfrc, xfrc, steps, q_target=None, tol=TOL, seen=None):
    """Step both from the JAX trajectory; every output within `tol`. `seen`
    collects the largest magnitude of each JAX output."""
    for _ in range(steps):
        jo = jfused.physics_step_fused(
            jm, jp, jnp.asarray(q), jnp.asarray(qd), jnp.asarray(qfrc),
            xfrc=None if xfrc is None else jnp.asarray(xfrc),
            q_target=None if q_target is None else jnp.asarray(q_target), use_pallas=False,
        )
        to = tfused.physics_step_fused(
            tm, tp, torch.tensor(q), torch.tensor(qd), torch.tensor(qfrc),
            xfrc=None if xfrc is None else torch.tensor(xfrc),
            q_target=None if q_target is None else torch.tensor(q_target),
        )
        for k, t in tol.items():
            ref = np.asarray(getattr(jo, k))
            err = float(np.max(np.abs(ref - getattr(to, k).numpy())))
            assert err < t, (k, err)
            if seen is not None:
                seen[k] = max(seen.get(k, 0.0), float(np.abs(ref).max()))
        q, qd = np.asarray(jo.q), np.asarray(jo.qd)
    return q, qd


@pytest.mark.parametrize("with_xfrc", [False, True])
def test_twin_matches_jax_ant(ant, with_xfrc):
    jenv, tenv, q, qd = ant
    rng = np.random.RandomState(1)
    qfrc = (rng.uniform(-1, 1, (4, tenv.model.nv)) * 3.0).astype(np.float32)
    xfrc = rng.uniform(-1, 1, (4, tenv.model.nbody, 6)).astype(np.float32) if with_xfrc else None
    _compare(jenv.model, jenv.sim_params, tenv.model, tenv.sim_params, q, qd, qfrc, xfrc, 3)


@pytest.fixture(scope="module")
def cartpole():
    """JAX Cartpole env and the port's, both reading the bundled URDF."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Cartpole"]({k: dict(v) for k, v in CFG.items()})
        tenv = ttasks["Cartpole"]({k: dict(v) for k, v in CFG.items()}, device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("jax_rows", ["nc0", "nc24"])
def test_twin_matches_jax_cartpole(cartpole, jax_rows):
    """The contact-free step (nc == 0) against the JAX fused math: against
    its own nc == 0 branch (the model with plane_contacts off), and against
    the JAX Cartpole as it is, whose 24 candidate rows hang a metre above
    the ground and never act."""
    jenv, tenv = cartpole
    jm = jenv.model.replace(plane_contacts=False) if jax_rows == "nc0" else jenv.model
    assert tfused._extract(tenv.model).nc == 0 and jenv.model.ncp == 24
    rng = np.random.RandomState(3)
    q = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
    qd = rng.uniform(-2, 2, (4, 2)).astype(np.float32)
    qfrc = rng.uniform(-100, 100, (4, 2)).astype(np.float32)
    q2, _ = _compare(jm, jenv.sim_params, tenv.model, tenv.sim_params, q, qd, qfrc, None, 3)
    assert float(np.abs(q2 - q).max()) > 0.05  # the step moved the state
    out = tfused.physics_step_fused(tenv.model, tenv.sim_params, torch.tensor(q), torch.tensor(qd),
                                    torch.tensor(qfrc))
    for k in ("body_force", "body_torque", "dof_force"):
        assert float(getattr(out, k).abs().max()) == 0.0


def test_contact_free_counts_and_layout(ant, cartpole):
    """kernel_flops without contacts is positive and below the count with
    one; the spec buffer's contact regions have zero width."""
    _, tenv = cartpole
    m, p = tenv.model, tenv.sim_params
    s = tfused._extract(m)
    with_contacts = tfused._extract(m.replace(plane_contacts=True))
    assert (s.nbody, s.nq, s.nv, s.nc) == (3, 2, 2, 0) and with_contacts.nc == 24
    assert 0 < _cuda.kernel_flops(s, p) < _cuda.kernel_flops(with_contacts, p)
    one = with_contacts._replace(nc=1)
    assert _cuda.kernel_flops(s, p) < _cuda.kernel_flops(one, p)
    assert _cuda.kernel_bytes(s, 512, False) == 4 * 512 * (2 + 2 * 2 + 2 + 2 + 6 * 3 + 2)
    spec = _cuda.pack_spec(s, p, tfused.apgd_betas(p.solver_apgd_iterations))
    nb, nv = s.nbody, s.nv
    base = 16 + 5 * nb + 3 * nb + 4 * nb + 3 * nb + 9 * nb + nb + 6 * nb + 10 * nv + nv * nv + nb * nb
    assert spec.shape == (base + p.solver_apgd_iterations,) and spec.dtype == np.float32
    # Ant's count is what it was before the contact-free gate
    _, aenv, _, _ = ant
    assert _cuda.kernel_flops(tfused._extract(aenv.model), aenv.sim_params) == 471095


def test_port_sim_params_match_jax(ant):
    jenv, tenv, _, _ = ant
    jp, tp = jenv.sim_params, tenv.sim_params
    for f in ("dt", "substeps", "solver_iterations", "solver_apgd_iterations",
              "contact_margin", "baumgarte_erp", "max_depenetration_velocity",
              "bounce_threshold_velocity", "max_dof_velocity"):
        assert getattr(jp, f) == pytest.approx(getattr(tp, f)), f
    np.testing.assert_allclose(np.asarray(jp.gravity), tp.gravity)


def _ball():
    """The restitution fixture of tests/test_fused.py: a sphere (e=0.8)."""
    b = ModelBuilder()
    body = b.add_body(parent=-1, name="ball", pos=(0, 0, 0), quat=(0, 0, 0, 1),
                      jnt_type=FREE, mass=1.0, inertia=np.eye(3) * 1e-3)
    b.qpos0_free[body] = (np.array([0, 0, 1.0], np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(body, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (0.1, 0, 0), 0.5)
    m = b.finalize()
    m, idx = add_contact_points(m, body, np.array([[0.0, 0.0, -0.1]], np.float32), friction=0.5)
    return m.replace(cpoint_restitution=jnp.zeros(m.ncp).at[idx[0]].set(0.8))


def test_twin_matches_jax_restitution_ball():
    jm = _ball()
    jp = JSimParams(dt=1 / 120, substeps=2, baumgarte_erp=0.1)
    tm = model_from_arrays(_jax_fields(jm))
    tp = SimParams(dt=1 / 120, substeps=2, baumgarte_erp=0.1)
    assert tfused.fused_supported(tm, tp)
    n = 4
    q = np.tile(np.asarray(jm.qpos0), (n, 1)).astype(np.float32)
    qd = np.zeros((n, jm.nv), np.float32)
    qd[:, 2] = -3.0
    zero = np.zeros((n, jm.nv), np.float32)
    bounced = False
    for _ in range(30):
        q, qd = _compare(jm, jp, tm, tp, q, qd, zero, None, 1)
        bounced = bounced or float(qd[0, 2]) > 1.8
    assert bounced


def test_unsupported_models_raise(ant):
    """What is still beyond the ported tiers raises by name: geom-geom pairs,
    a pair row against a capsule, a top-K cap that leaves no room beside the
    anchors, a model whose kernel block would not fit the card's shared
    memory at one env per block, terrain planes for a model without plane
    candidates. Pair rows against sphere, box, cylinder and mesh geoms,
    anchors, q_target, tendons, per-env leaves (`dyn`), a top-K cap below the
    row count (pair and anchor rows counted), terrain planes, SDF pair rows
    and merged decimation windows (`warm_reset_every`) no longer do; SDF
    planes for a model without SDF pair rows and an unknown `dyn` key are
    ValueErrors and an inert key is dropped."""
    _, tenv, q, qd = ant
    m, p = tenv.model, tenv.sim_params
    assert tfused.fused_supported(m, p)
    args = (torch.tensor(q), torch.tensor(qd), torch.zeros(4, m.nv))
    topk = SimParams(**{**p.__dict__, "max_active_contacts": 8})
    capsule = m.geom_type.index(1)
    tendon = m.replace(tendon_coef=np.ones((1, m.nv), np.float32), tendon_range=np.zeros((1, 2), np.float32),
                       tendon_stiffness=np.ones(1, np.float32), tendon_damping=np.ones(1, np.float32))
    anchors = m.replace(att_body=(0, 0), att_offset=np.zeros((2, 3), np.float32),
                        att_target=np.zeros((2, 3), np.float32))
    cap2 = SimParams(**{**p.__dict__, "max_active_contacts": 2})
    sphere = m.geom_type.index(0)
    cases = [
        (m.replace(pair_geom_a=(0,), pair_geom_b=(1,)), p, {}, "pair_geom_a"),
        (m.replace(ppair_point=(0,), ppair_geom=(capsule,)), p, {}, "capsule"),
        (anchors, cap2, {}, "top-K active set with max_active_contacts=2 <= 2 anchors"),
        (m.replace(ppair_point=(0,) * 800, ppair_geom=(sphere,) * 800), p, {}, "shared memory: .* bytes"),
    ]
    for model, params, kw, word in cases:
        # the feature check precedes any device dispatch, so the CUDA path
        # raises the same way for these
        with pytest.raises(NotImplementedError, match=word):
            tfused.physics_step_fused(model, params, *args, **kw)
        if not kw:
            assert not tfused.fused_supported(model, params)
    # terrain needs plane candidates
    assert tfused.fused_supported(m, p, terrain=object())
    assert not tfused.fused_supported(m.replace(plane_contacts=False), p, terrain=object())
    # the cap counts pair and anchor rows: 25 plane rows + 1 pair row > 25
    pair = m.replace(ppair_point=(0,), ppair_geom=(m.geom_type.index(0),))
    cap25 = SimParams(**{**p.__dict__, "max_active_contacts": 25})
    assert tfused.topk_cap(tfused._extract(m), cap25) == 0 and tfused.topk_cap(tfused._extract(pair), cap25) == 25
    assert tfused.fused_supported(pair, cap25) and tfused.fused_supported(anchors, SimParams(**{**p.__dict__, "max_active_contacts": 3}))
    # MESH (5) pair geoms ride the cylinder branch
    mesh = pair.replace(geom_type=tuple(5 if i == pair.ppair_geom[0] else t for i, t in enumerate(pair.geom_type)))
    assert tfused.fused_supported(mesh, p) and tfused._extract(mesh).pp_gtype.tolist() == [3]
    # ported now: q_target on a CPU tensor runs the plain version
    out = tfused.physics_step_fused(m, p, *args, q_target=torch.tensor(q))
    assert bool(torch.isfinite(out.q).all())
    # ported now: tendons, per-env leaves, a top-K cap, terrain planes and
    # warm resets; each changes the step
    assert tfused.fused_supported(tendon, p) and tfused.fused_supported(m, topk)
    mass = torch.tensor(np.asarray(m.body_mass, np.float32)).repeat(4, 1)
    plain = tfused.physics_step_fused(m, p, *args)
    ramp = {k: torch.zeros(4, m.ncp) for k in tfused.TERRAIN_KEYS}
    ramp["_terr_h"] = torch.full((4, m.ncp), 0.3)  # the ground 30 cm higher under every point: the legs in it
    ramp["_terr_n2"] = torch.ones(4, m.ncp)
    ramp["_terr_t10"] = torch.ones(4, m.ncp)
    ramp["_terr_t21"] = torch.ones(4, m.ncp)
    two = SimParams(**{**p.__dict__, "substeps": 4, "dt": 2 * p.dt})
    raised = tfused.physics_step_fused(m, p, *args, dyn=ramp)
    for o, ref in ((tfused.physics_step_fused(tendon, p, *args), plain),
                   (tfused.physics_step_fused(m, p, *args, dyn={"body_mass": 2.0 * mass}), plain),
                   (raised, plain),
                   (tfused.physics_step_fused(m, topk, *args, dyn=ramp), raised)):
        assert bool(torch.isfinite(o.q).all()) and float((o.qd - ref.qd).abs().max()) > 1e-3
    a = tfused.physics_step_fused(m, two, *args, dyn=ramp, warm_reset_every=2)
    b = tfused.physics_step_fused(m, two, *args, dyn=ramp)
    assert bool(torch.isfinite(a.q).all()) and float((a.qd - b.qd).abs().max()) > 0.0
    # an inert leaf is dropped, as is a tendon leaf of a model without tendons
    same = tfused.physics_step_fused(m, p, *args, dyn={"dof_max_effort": torch.ones(4, m.nv),
                                                       "tendon_damping": torch.ones(4, 0)})
    assert torch.equal(same.qd, plain.qd)
    with pytest.raises(ValueError, match="body_pos"):
        tfused.physics_step_fused(m, p, *args, dyn={"body_pos": torch.ones(4, m.nbody, 3)})
    with pytest.raises(ValueError, match="9 values per env"):
        tfused.physics_step_fused(m, p, *args, dyn={"body_mass": torch.ones(4, m.nbody + 1)})
    with pytest.raises(ValueError, match="given twice"):
        tfused.physics_step_fused(m, p, *args, dyn=ramp, terrain=tfused.pack_terrain(ramp))


def test_spec_buffer_layout(ant):
    """The packed constants have the length the kernel's layout expects."""
    _, tenv, _, _ = ant
    m, p = tenv.model, tenv.sim_params
    s = tfused._extract(m)
    spec = _cuda.pack_spec(s, p, tfused.apgd_betas(p.solver_apgd_iterations))
    nb, nv, nc = s.nbody, s.nv, s.nc
    base = 16 + 5 * nb + 3 * nb + 4 * nb + 3 * nb + 9 * nb + nb + 6 * nb + 10 * nv + nv * nv \
        + nb * nb + 7 * nc + nc * nv
    assert spec.shape == (base + p.solver_apgd_iterations,)
    assert spec.dtype == np.float32
    assert _cuda.kernel_flops(s, p) > 0 and _cuda.kernel_bytes(s, 4096, True) > 0
    assert _cuda.sizes_of(s) == (9, 15, 14, 25, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4)


# ---- q_target drives, pair rows and anchors ---------------------------------


def _port_params(jp):
    return SimParams(**{f.name: (tuple(np.asarray(getattr(jp, f.name)).tolist()) if f.name == "gravity"
                                 else getattr(jp, f.name)) for f in dataclasses.fields(SimParams)})


def _both_envs(name):
    """(name, JAX env, port env) from each package's own yaml at 4 envs."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    args = [f"task={name}", "num_envs=4"]
    return name, jtasks[name](jload(args)["task"]), ttasks[name](tload(args)["task"], device="cpu")


@pytest.fixture(scope="module", params=["Ingenuity", "Quadcopter", "BallBalance"])
def procedural(request):
    return _both_envs(request.param)


def test_twin_matches_jax_procedural_tasks(procedural):
    """The plain version against the JAX fused math, 3 steps: Ingenuity with
    xfrc (24 plane rows, Mars gravity), Quadcopter with xfrc and q_target (44
    plane rows), both with two envs resting on the ground; BallBalance with
    q_target, the ball resting on the tray so that the pair row acts (tray
    body force checked non-zero) beside its three anchors, at q 5e-4, qd
    5e-3, forces 5e-2 (the others q 2e-4, qd 2e-3, forces 2e-2)."""
    name, jenv, tenv = procedural
    jm, tm = jenv.model, tenv.model
    assert tfused.fused_supported(tm, tenv.sim_params)
    assert dataclasses.replace(_port_params(jenv.sim_params), gravity=tenv.sim_params.gravity) == tenv.sim_params
    np.testing.assert_allclose(np.asarray(jenv.sim_params.gravity), tenv.sim_params.gravity)
    n = 4
    rng = np.random.RandomState(7)
    q = np.tile(np.asarray(tm.qpos0), (n, 1)).astype(np.float32)
    qd = rng.uniform(-0.3, 0.3, (n, tm.nv)).astype(np.float32)
    qfrc = rng.uniform(-0.5, 0.5, (n, tm.nv)).astype(np.float32)
    xfrc, qt, tol = None, None, TOL
    if name == "BallBalance":
        bq = tenv.ball_q
        q[:, bq:bq + 2] = rng.uniform(-0.2, 0.2, (n, 2))
        q[:, bq + 2] = tenv.tray_height + 0.01 + tenv.ball_radius - 0.002
        qd[:] = 0.0
        qt = q + rng.uniform(-0.02, 0.02, q.shape).astype(np.float32)
        tol = {"q": 5e-4, "qd": 5e-3, "body_force": 5e-2, "body_torque": 5e-2, "dof_force": 5e-2}
    else:
        q[:2, 2] = (0.06, 0.065) if name == "Ingenuity" else (0.01, 0.02)
        xfrc = rng.uniform(-1, 1, (n, tm.nbody, 6)).astype(np.float32)
        if name == "Quadcopter":
            q[:, 7:] = rng.uniform(-0.2, 0.2, (n, 8))
            qt = q + rng.uniform(-0.1, 0.1, q.shape).astype(np.float32)
    assert (qt is not None) == tenv.use_pd_targets
    if name == "BallBalance":
        out = tfused.physics_step_fused(tm, tenv.sim_params, torch.tensor(q), torch.tensor(qd),
                                        torch.tensor(qfrc), q_target=torch.tensor(qt))
        assert float(out.body_force[:, tenv.tray_body, 2].abs().min()) > 1.0  # the pair row is active
    seen = {}
    q2, _ = _compare(jm, jenv.sim_params, tm, tenv.sim_params, q, qd, qfrc, xfrc, 3, q_target=qt, tol=tol, seen=seen)
    assert seen["body_force"] > 1.0 and float(np.abs(q2 - q).max()) > 1e-4


def _jax_pair_row_example():
    """The JAX-package build of `model.examples.pair_row_example`."""
    from isaacgymenvs_tpu.model.spec import GEOM_BOX, box_inertia, sphere_inertia
    from isaacgymenvs_tpu_torch.model import examples as ex

    b = ModelBuilder()
    quat = np.array([0, 0, 0, 1], np.float32)

    def free_body(name, mass, inertia, pos):
        i = b.add_body(parent=-1, name=name, pos=(0, 0, 0), quat=(0, 0, 0, 1),
                       jnt_type=FREE, mass=mass, inertia=inertia)
        b.qpos0_free[i] = (np.asarray(pos, np.float32), quat)
        return i

    top = 2 * ex.BOX_HALF[2]
    box = free_body("box", *box_inertia(400.0, ex.BOX_HALF), (0, 0, ex.BOX_HALF[2]))
    b.add_geom(box, GEOM_BOX, (0, 0, 0), (0, 0, 0, 1), ex.BOX_HALF, 1.0)
    a = free_body("ball_a", *sphere_inertia(300.0, ex.RADIUS_A), (0, 0, top + ex.RADIUS_A))
    b.add_geom(a, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (ex.RADIUS_A, 0, 0), 0.8)
    dx = float(np.sqrt((ex.RADIUS_A + ex.RADIUS_B) ** 2 - (ex.RADIUS_A - ex.RADIUS_B) ** 2))
    bb = free_body("ball_b", *sphere_inertia(300.0, ex.RADIUS_B), (dx, 0, top + ex.RADIUS_B))
    b.add_geom(bb, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (ex.RADIUS_B, 0, 0), 0.6)
    m = b.finalize()
    cp_a, cp_b = m.cpoint_body.index(a), m.cpoint_body.index(bb)
    return m.replace(ppair_point=(cp_a, cp_b, cp_b), ppair_geom=(0, 0, 1))


@pytest.mark.parametrize("inside", [False, True], ids=["touching", "centre_inside_box"])
def test_twin_matches_jax_box_and_sphere_pair_rows(inside):
    """The example model (point vs BOX twice, point vs SPHERE once), all three
    pair rows active, 3 steps against the JAX fused math with xfrc. With
    `inside` sphere A's centre starts below the box's top face, which takes
    the BOX branch's inside case (leave through the nearest face); that
    start is violent, so it is held for one step."""
    from isaacgymenvs_tpu_torch.model.examples import pair_row_example, pair_row_example_state

    jm, tm = _jax_pair_row_example(), pair_row_example()
    carried = model_from_arrays(_jax_fields(jm))
    for f in dataclasses.fields(tm):
        a, b = getattr(tm, f.name), getattr(carried, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f.name)
        else:
            assert a == b, f.name
    kw = dict(dt=1 / 60, substeps=2, solver_apgd_iterations=16, contact_margin=0.02)
    jp, tp = JSimParams(**kw), SimParams(**kw)
    s = tfused._extract(tm)
    assert (s.nc, s.pp_nc, s.att_n, s.nct) == (10, 3, 0, 13) and s.pp_gtype.tolist() == [2, 2, 0]
    n = 4
    q, qd = pair_row_example_state(tm, n, 1)
    if inside:
        q[:, tm.q_adr[1] + 2] -= 0.105  # A's centre 7 mm under the face
        qd[:] = 0.0
    rng = np.random.RandomState(8)
    qfrc = rng.uniform(-0.3, 0.3, (n, tm.nv)).astype(np.float32)
    xfrc = rng.uniform(-0.2, 0.2, (n, tm.nbody, 6)).astype(np.float32)
    seen = {}
    _compare(jm, jp, tm, tp, q, qd, qfrc, xfrc, 1 if inside else 3, seen=seen)
    assert seen["body_force"] > 1.0


def test_extract_matches_jax_ball_balance():
    """`_extract` of the port against the JAX `_extract`: every shared field,
    and the pair-row and anchor fields, whose one-hot pick matrices are index
    arrays here."""
    _, jenv, tenv = _both_envs("BallBalance")
    js, ts = jfused._extract(jenv.model), tfused._extract(tenv.model)
    assert (ts.nc, ts.pp_nc, ts.att_n, ts.nct) == (21, 1, 3, 25) == (js.nc, js.pp_nc, js.att_n, 25)
    assert _cuda.sizes_of(ts, True) == (8, 20, 18, 21, 1, 3, 1, 0, 0, 0, 0, 0, 0, 0, 4)
    for f in ts._fields:
        if f in ("pp_a", "pp_b", "att_body", "free_bodies", "ncp_model", "ngeom", "pp_pt", "pp_geom",
                 "sp_a", "sp_b", "sp_pt"):
            continue
        a, b = getattr(ts, f), getattr(js, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, err_msg=f)
        else:
            assert a == b, f
    assert ts.free_bodies == js.free_bodies
    np.testing.assert_array_equal(ts.pp_a, np.argmax(js.pp_pick_a, 1))
    np.testing.assert_array_equal(ts.pp_b, np.argmax(js.pp_pick_b, 1))
    np.testing.assert_array_equal(ts.att_body, np.argmax(js.att_pick, 1))
    np.testing.assert_array_equal(ts.pp_pt, np.argmax(js.pp_pick_pt, 1))
    np.testing.assert_array_equal(ts.pp_geom, np.argmax(js.pp_pick_geom, 1))
    assert (ts.ncp_model, ts.ngeom) == (js.pp_pick_pt.shape[1], js.pp_pick_geom.shape[1])
    assert ts.pp_gtype.tolist() == [3] and ts.pp_path.shape == (18, 1) and ts.att_path.shape == (18, 3)
    # the spec buffer holds them at the kernel's offsets
    p = tenv.sim_params
    spec = _cuda.pack_spec(ts, p, tfused.apgd_betas(p.solver_apgd_iterations))
    nb, nv, nct = ts.nbody, ts.nv, ts.nct
    base = 16 + 5 * nb + 3 * nb + 4 * nb + 3 * nb + 9 * nb + nb + 6 * nb + 10 * nv + nv * nv \
        + nb * nb + 7 * nct + nct * nv + 15 * ts.pp_nc + 3 * ts.att_n
    assert spec.shape == (base + p.solver_apgd_iterations,) and spec[14] == np.float32(0.7)
    np.testing.assert_allclose(spec[base - 9:base], ts.att_target.reshape(-1))
    assert _cuda.kernel_flops(ts, p) > _cuda.kernel_flops(ts._replace(pp_nc=0, att_n=0, pp_gtype=ts.pp_gtype[:0]), p)
    assert _cuda.kernel_bytes(ts, 8, False, True) - _cuda.kernel_bytes(ts, 8, False) == 4 * 8 * ts.nq


def test_forward_kinematics_matches_jax(ant):
    from isaacgymenvs_tpu.engine import dynamics as jdyn
    from isaacgymenvs_tpu_torch.engine import dynamics as tdyn

    jenv, tenv, q, qd = ant
    qd = qd + np.random.RandomState(4).uniform(-1, 1, qd.shape).astype(np.float32)
    jfk = jax.jit(jax.vmap(lambda a, b: jdyn.forward_kinematics(jenv.model, a, b)))
    jk = jfk(jnp.asarray(q), jnp.asarray(qd))
    tk = tdyn.forward_kinematics(tenv.model, torch.tensor(q), torch.tensor(qd))
    for f in ("x", "quat", "com", "inertia_w", "S", "Sdot", "v"):
        np.testing.assert_allclose(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)), atol=1e-5, err_msg=f)


# ---- per-env leaves (dyn) and tendons ----------------------------------------

EX_PARAMS = dict(dt=1 / 60, substeps=2, solver_apgd_iterations=16, contact_margin=0.02)


def _compare_dyn(jm, jp, tm, tp, q, qd, qfrc, xfrc, dyn, steps=3, q_target=None, tol=TOL):
    """Both packages from the JAX trajectory with the same per-env leaves
    (numpy arrays); every output within `tol`. Returns the largest gap
    between the port's step with and without the leaves, per output."""
    J = lambda a: None if a is None else jnp.asarray(a)
    Tn = lambda a: None if a is None else torch.tensor(a)
    gap = {}
    for _ in range(steps):
        jo = jfused.physics_step_fused(jm, jp, J(q), J(qd), J(qfrc), xfrc=J(xfrc), q_target=J(q_target),
                                       use_pallas=False, dyn={k: J(v) for k, v in dyn.items()} if dyn else None)
        to = tfused.physics_step_fused(tm, tp, Tn(q), Tn(qd), Tn(qfrc), xfrc=Tn(xfrc), q_target=Tn(q_target),
                                       dyn={k: Tn(v) for k, v in dyn.items()} if dyn else None)
        bare = tfused.physics_step_fused(tm, tp, Tn(q), Tn(qd), Tn(qfrc), xfrc=Tn(xfrc), q_target=Tn(q_target))
        for k, t in tol.items():
            err = float(np.max(np.abs(np.asarray(getattr(jo, k)) - getattr(to, k).numpy())))
            assert err < t, (k, err)
            gap[k] = max(gap.get(k, 0.0), float((getattr(to, k) - getattr(bare, k)).abs().max()))
        q, qd = np.asarray(jo.q), np.asarray(jo.qd)
    return gap


def test_twin_with_dyn_matches_jax_ant(ant):
    """The six leaves of tests/test_fused.py::test_fused_dyn_leaves_match_vmap
    (damping, stiffness, armature, mass, contact friction, gravity) per env
    on Ant, 3 steps against the JAX fused math given the same leaves."""
    jenv, tenv, q, qd = ant
    m, n = tenv.model, 4
    rng = np.random.RandomState(0)
    scaled = lambda leaf, lo, hi: (np.asarray(getattr(m, leaf), np.float32)[None]
                                   * rng.uniform(lo, hi, (n,) + np.shape(getattr(m, leaf)))).astype(np.float32)
    dyn = {
        "dof_damping": scaled("dof_damping", 0.5, 2.0),
        "dof_stiffness": scaled("dof_stiffness", 0.8, 1.2),
        "armature": scaled("armature", 0.8, 1.2),
        "body_mass": scaled("body_mass", 0.8, 1.2),
        "cpoint_friction": scaled("cpoint_friction", 0.7, 1.3),
        "gravity": (np.asarray(tenv.sim_params.gravity, np.float32)[None] * rng.uniform(0.9, 1.1, (n, 3))).astype(np.float32),
    }
    qfrc = (rng.uniform(-1, 1, (n, m.nv)) * 2.0).astype(np.float32)
    gap = _compare_dyn(jenv.model, jenv.sim_params, m, tenv.sim_params, q, qd, qfrc, None, dyn)
    assert gap["qd"] > 1e-2  # the leaves changed the step


@pytest.mark.parametrize("leaves", ["tendons_only", "all_leaves"])
def test_twin_matches_jax_tendon_example(leaves):
    """The tendon example model (`model.examples.tendon_chain_example`, built
    for the JAX package by the same calls on its ModelBuilder): a fixed
    tendon stretched past its range, restitution on the box's plane rows
    (half the envs come down faster than the bounce threshold), one
    point-vs-box pair row. Without per-env leaves, and with all fifteen
    leaves and gravity, 3 steps with xfrc."""
    from isaacgymenvs_tpu.model import spec as jspec
    from isaacgymenvs_tpu_torch.model import examples as ex

    jm, tm = ex.tendon_chain_example(jspec), ex.tendon_chain_example()
    carried = model_from_arrays(_jax_fields(jm))
    for f in dataclasses.fields(tm):
        a, b = getattr(tm, f.name), getattr(carried, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f.name)
        else:
            assert a == b, f.name
    jp, tp = JSimParams(**EX_PARAMS), SimParams(**EX_PARAMS)
    s = tfused._extract(tm)
    assert (s.nbody, s.nq, s.nv, s.nc, s.pp_nc, s.nt, s.ncp_model, s.ngeom) == (3, 9, 8, 10, 1, 1, 10, 3)
    assert tfused.fused_supported(tm, tp) and float(tm.tendon_stiffness[0]) == 5.0 and np.any(s.rest > 0)
    n = 4
    q, qd = ex.tendon_chain_example_state(tm, n, 1)
    qd[:2, 2] = -0.6
    rng = np.random.RandomState(8)
    qfrc = rng.uniform(-0.3, 0.3, (n, tm.nv)).astype(np.float32)
    xfrc = rng.uniform(-0.2, 0.2, (n, tm.nbody, 6)).astype(np.float32)
    if leaves == "tendons_only":
        _compare_dyn(jm, jp, tm, tp, q, qd, qfrc, xfrc, None)
        # the tendon acts: without it the arm's hinges move otherwise
        bare = tm.replace(tendon_coef=None)
        T = torch.tensor
        a = tfused.physics_step_fused(tm, tp, T(q), T(qd), T(qfrc))
        b = tfused.physics_step_fused(bare, tp, T(q), T(qd), T(qfrc))
        assert float((a.qd[:, 6:] - b.qd[:, 6:]).abs().min()) > 1e-3
        return
    dyn = ex.random_leaves(tm, tfused.DYN_ORDER, n, 3, tp.gravity)
    assert set(dyn) == set(tfused.DYN_LEAVES) | {"gravity"}
    packed = tfused.pack_dyn(s, {k: torch.tensor(v) for k, v in dyn.items()})
    assert packed.names == tfused.DYN_ORDER and packed.rows.shape == (151, n)
    gap = _compare_dyn(jm, jp, tm, tp, q, qd, qfrc, xfrc, dyn)
    assert gap["qd"] > 1e-2 and gap["body_force"] > 1.0


def test_twin_with_pair_row_leaves_matches_jax_ball_balance():
    """BallBalance with per-env cpoint_friction, cpoint_pos, geom_size and
    body_mass (what a pair row reads), the ball on the tray, q_target drives;
    q 5e-4, qd 5e-3, forces 5e-2 as the BallBalance step without leaves."""
    _, jenv, tenv = _both_envs("BallBalance")
    from isaacgymenvs_tpu_torch.model.examples import random_leaves

    tm, n = tenv.model, 4
    rng = np.random.RandomState(7)
    q = np.tile(np.asarray(tm.qpos0), (n, 1)).astype(np.float32)
    bq = tenv.ball_q
    q[:, bq:bq + 2] = rng.uniform(-0.2, 0.2, (n, 2))
    q[:, bq + 2] = tenv.tray_height + 0.01 + tenv.ball_radius - 0.002
    qd = np.zeros((n, tm.nv), np.float32)
    qfrc = rng.uniform(-0.5, 0.5, (n, tm.nv)).astype(np.float32)
    qt = q + rng.uniform(-0.02, 0.02, q.shape).astype(np.float32)
    dyn = random_leaves(tm, ("cpoint_friction", "cpoint_pos", "geom_size", "body_mass"), n, 5)
    tol = {"q": 5e-4, "qd": 5e-3, "body_force": 5e-2, "body_torque": 5e-2, "dof_force": 5e-2}
    gap = _compare_dyn(jenv.model, jenv.sim_params, tm, tenv.sim_params, q, qd, qfrc, None, dyn, q_target=qt, tol=tol)
    assert gap["body_force"] > 0.1


def test_dyn_layout_sizes_and_spec_regions(ant):
    """The packed per-env input, the size tuple and the spec buffer's new
    regions: leaf order and rows, comp-major component leaves, the bitmask,
    tendon and pair-row index regions at the kernel's offsets, and the bytes
    and operations the bounds count."""
    from isaacgymenvs_tpu_torch.model.examples import random_leaves, tendon_chain_example

    tm, tp = tendon_chain_example(), SimParams(**EX_PARAMS)
    s = tfused._extract(tm)
    rows = tfused.dyn_rows(s)
    assert [rows[k] for k in tfused.DYN_ORDER] == [8, 8, 8, 8, 8, 8, 3, 10, 10, 1, 1, 9, 27, 30, 9, 3]
    assert tfused.dyn_mask(()) == 0 and tfused.dyn_mask(tfused.DYN_ORDER) == 2 ** 16 - 1
    assert tfused.dyn_mask(("body_mass", "gravity")) == (1 << 6) | (1 << 15)
    # order is DYN_ORDER whatever the dict's order; inert and zero-row leaves go
    n = 3
    dyn = {k: torch.tensor(v) for k, v in random_leaves(tm, ("gravity", "geom_size", "body_inertia", "body_mass"), n, 1).items()}
    packed = tfused.pack_dyn(s, {**dyn, "dof_max_effort": torch.ones(n, 8)})
    assert packed.names == ("body_mass", "body_inertia", "geom_size", "gravity")
    assert packed.rows.shape == (3 + 27 + 9 + 3, n) and packed.rows.is_contiguous()
    # comp-major: row = component * entities + entity
    np.testing.assert_array_equal(packed.rows[3 + (1 * 3 + 2) * 3 + 1].numpy(), dyn["body_inertia"][:, 1, 1, 2].numpy())
    np.testing.assert_array_equal(packed.rows[30 + 0 * 3 + 2].numpy(), dyn["geom_size"][:, 2, 0].numpy())
    np.testing.assert_array_equal(packed.rows[39:].numpy(), dyn["gravity"].T.numpy())
    assert tfused.pack_dyn(s, {}) is None and tfused.pack_dyn(s, {"dof_max_effort": torch.ones(n, 8)}) is None
    # size tuple: tendons, bitmask, and the cpoint / geom counts only where a leaf indexes them
    assert _cuda.sizes_of(s) == (3, 9, 8, 10, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 4)
    assert _cuda.sizes_of(s, False, packed.names) == (3, 9, 8, 10, 1, 0, 0, 1, packed_mask := tfused.dyn_mask(packed.names), 0, 3, 0, 0, 0, 4)
    assert packed_mask == (1 << 6) | (1 << 12) | (1 << 14) | (1 << 15)
    assert _cuda.sizes_of(s, False, ("cpoint_pos",))[8:] == (1 << 13, 10, 0, 0, 0, 0, 4)
    assert "-DFS_NT=1" in _cuda._defines(_cuda.sizes_of(s)) and "-DFS_DYN=0" in _cuda._defines(_cuda.sizes_of(s))
    # spec buffer: pair-row indices and the tendon before the anchors' targets
    spec = _cuda.pack_spec(s, tp, tfused.apgd_betas(tp.solver_apgd_iterations))
    nb, nv, nct, nt = s.nbody, s.nv, s.nct, s.nt
    base = 16 + 5 * nb + 3 * nb + 4 * nb + 3 * nb + 9 * nb + nb + 6 * nb + 10 * nv + nv * nv \
        + nb * nb + 7 * nct + nct * nv + 15 * s.pp_nc + nt * (nv + 4) + 3 * s.att_n
    assert spec.shape == (base + tp.solver_apgd_iterations,)
    t0 = base - nt * (nv + 4)
    np.testing.assert_array_equal(spec[t0:t0 + nv], [0, 0, 0, 0, 0, 0, 1.0, 0.5])
    np.testing.assert_allclose(spec[t0 + nv:base], [-0.3, 0.3, 5.0, 0.5])
    assert spec[t0 - 3:t0].tolist() == [float(s.pp_pt[0]), float(s.pp_geom[0]), 1.0]  # point 9, the box geom, its friction
    # the bounds: tendons add operations, per-env rows add bytes (Ant's five leaves: 65 floats per env)
    assert _cuda.kernel_flops(s, tp) > _cuda.kernel_flops(s._replace(tendon_coef=None), tp)
    assert _cuda.kernel_bytes(s, 8, True, False, packed.names) - _cuda.kernel_bytes(s, 8, True) == 4 * 8 * 42
    sa = tfused._extract(ant[1].model)
    five = ("dof_damping", "dof_stiffness", "dof_limit_lower", "dof_limit_upper", "body_mass")
    assert _cuda.kernel_bytes(sa, 1, True, False, five) - _cuda.kernel_bytes(sa, 1, True) == 4 * 65
    assert _cuda.sizes_of(sa, False, five) == (9, 15, 14, 25, 0, 0, 0, 0, 115, 0, 0, 0, 0, 0, 4)


def test_plain_step_in_float64(ant):
    """`_step_math_torch(dtype=torch.float64)` takes float64 inputs and
    agrees with the float32 step within the tolerances (it measures how
    far float32 rounding moves a step; chip_smoke.py picks its comparison
    inputs with it)."""
    _, tenv, q, qd = ant
    m, p = tenv.model, tenv.sim_params
    s = tfused._extract(m)
    rng = np.random.RandomState(5)
    qfrc = rng.uniform(-3, 3, (4, m.nv)).astype(np.float32)
    ins = [torch.tensor(a).T.contiguous() for a in (q, qd, qfrc)]
    a = tfused._step_math_torch(s, p, torch.device("cpu"))(*ins, None)
    b = tfused._step_math_torch(s, p, torch.device("cpu"), dtype=torch.float64)(*(x.double() for x in ins), None)
    assert b[0].dtype == torch.float64
    for k, (x, y) in zip(TOL, zip(a, b)):
        assert float((x.double() - y).abs().max()) < TOL[k] / 4, k
