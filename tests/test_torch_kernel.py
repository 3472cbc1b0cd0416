"""The hand-written fused-step kernel against its plain PyTorch version.

This file imports no JAX, so it also runs on the GPU machine:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -p no:cacheprovider

The `cuda`-marked tests skip where there is no card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import resolve_device
from isaacgymenvs_tpu_torch.engine import _cuda
from isaacgymenvs_tpu_torch.engine import fused
from isaacgymenvs_tpu_torch.tasks import task_map

TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}


def _ant(n, device):
    cfg = {"env": {"numEnvs": n, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    return task_map["Ant"](cfg, device=device)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def test_cpu_tensors_take_the_plain_version():
    env = _ant(3, "cpu")
    state, _ = env.reset(0)
    before = _cuda.FusedStepCall.launches
    out = fused.physics_step_fused(env.model, env.sim_params, state.sim.q, state.sim.qd,
                                   torch.zeros(3, env.model.nv))
    assert _cuda.FusedStepCall.launches == before
    assert out.q.shape == (3, env.model.nq) and out.body_force.shape == (3, env.model.nbody, 3)
    assert bool(torch.isfinite(out.qd).all())


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        _ant(3, "cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.cuda
def test_kernel_matches_plain_version():
    _needs_card()
    n = 37  # not a multiple of the envs per block: the ragged edge
    env = _ant(n, "cuda")
    m, p = env.model, env.sim_params
    state, _ = env.reset(1)
    rng = np.random.RandomState(2)
    qfrc = torch.tensor(rng.uniform(-3, 3, (n, m.nv)).astype(np.float32), device="cuda")
    xfrc = torch.tensor(rng.uniform(-1, 1, (n, m.nbody, 6)).astype(np.float32), device="cuda")
    plain = fused._step_math_torch(fused._extract(m), p, torch.device("cuda"))
    q, qd = state.sim.q, state.sim.qd
    for _ in range(3):
        before = _cuda.FusedStepCall.launches
        ko = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc)
        assert _cuda.FusedStepCall.launches == before + 1
        po = plain(q.T.contiguous(), qd.T.contiguous(), qfrc.T.contiguous(),
                   xfrc.permute(2, 1, 0).reshape(6 * m.nbody, n).contiguous())
        torch.cuda.synchronize()
        ref = {"q": po[0].T, "qd": po[1].T,
               "body_force": po[2].reshape(3, m.nbody, n).permute(2, 1, 0),
               "body_torque": po[3].reshape(3, m.nbody, n).permute(2, 1, 0),
               "dof_force": po[4].T}
        for k, tol in TOL.items():
            assert float((getattr(ko, k) - ref[k]).abs().max()) < tol, k
        q, qd = ref["q"].contiguous(), ref["qd"].contiguous()


@pytest.mark.cuda
def test_contact_free_kernel_matches_plain_version():
    """The nc == 0 instantiation (Cartpole) against `_step_math_torch`:
    q within 2e-4 and qd within 2e-3, the three force outputs exactly 0."""
    _needs_card()
    n = 37
    cfg = {"env": {"numEnvs": n, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    env = task_map["Cartpole"](cfg, device="cuda")
    m, p = env.model, env.sim_params
    assert fused._extract(m).nc == 0
    state, _ = env.reset(1)
    rng = np.random.RandomState(2)
    qfrc = torch.tensor(rng.uniform(-100, 100, (n, m.nv)).astype(np.float32), device="cuda")
    plain = fused._step_math_torch(fused._extract(m), p, torch.device("cuda"))
    q, qd = state.sim.q, state.sim.qd
    for _ in range(3):
        before = _cuda.FusedStepCall.launches
        ko = fused.physics_step_fused(m, p, q, qd, qfrc)
        assert _cuda.FusedStepCall.launches == before + 1
        po = plain(q.T.contiguous(), qd.T.contiguous(), qfrc.T.contiguous(), None)
        torch.cuda.synchronize()
        assert float((ko.q - po[0].T).abs().max()) < TOL["q"]
        assert float((ko.qd - po[1].T).abs().max()) < TOL["qd"]
        for k in ("body_force", "body_torque", "dof_force"):
            assert float(getattr(ko, k).abs().max()) == 0.0
        q, qd = po[0].T.contiguous(), po[1].T.contiguous()


@pytest.mark.cuda
def test_unsupported_model_raises_on_card():
    """What the kernel cannot take raises by name on CUDA tensors too: a
    model whose block would not fit the card's shared memory at one env
    (800 pair rows), a top-K cap that leaves no room beside the anchors. A
    cap below the row count, terrain planes and a merged window's warm
    resets launch."""
    _needs_card()
    env = _ant(4, "cuda")
    state, _ = env.reset(0)
    m, p = env.model, env.sim_params
    args = (state.sim.q, state.sim.qd, torch.zeros(4, m.nv, device="cuda"))
    anchors = m.replace(att_body=(0, 0), att_offset=np.zeros((2, 3), np.float32),
                        att_target=np.zeros((2, 3), np.float32))
    sphere = m.geom_type.index(0)
    for model, params, kw, word in (
        (m.replace(ppair_point=(0,) * 800, ppair_geom=(sphere,) * 800), p, {}, "shared memory"),
        (anchors, dataclasses.replace(p, max_active_contacts=2), {}, "top-K"),
    ):
        with pytest.raises(NotImplementedError, match=word):
            fused.physics_step_fused(model, params, *args, **kw)
    before = _cuda.FusedStepCall.launches
    planes = {k: torch.zeros(4, m.ncp, device="cuda") for k in fused.TERRAIN_KEYS}
    planes["_terr_n2"] = planes["_terr_t10"] = planes["_terr_t21"] = torch.ones(4, m.ncp, device="cuda")
    out = fused.physics_step_fused(m, dataclasses.replace(p, max_active_contacts=8), *args, dyn=planes,
                                   warm_reset_every=1)
    torch.cuda.synchronize()
    assert _cuda.FusedStepCall.launches == before + 1 and bool(torch.isfinite(out.q).all())


def _held_against_plain(model, params, q, qd, qfrc, xfrc, q_target, steps, tol, dyn=None):
    """Kernel and plain version from the same inputs each step, the plain
    output carrying the trajectory; returns the largest |body_force|. `dyn`
    is a `fused.PackedDyn` of per-env leaves or None."""
    n, nb = q.shape[0], model.nbody
    rows = lambda a: None if a is None else a.T.contiguous()
    names, dyn_rows = (dyn.names, dyn.rows) if dyn is not None else ((), None)
    plain = fused._step_math_torch(fused._extract(model), params, torch.device("cuda"), names)
    xr = None if xfrc is None else xfrc.permute(2, 1, 0).reshape(6 * nb, n).contiguous()
    force = 0.0
    for _ in range(steps):
        before = _cuda.FusedStepCall.launches
        ko = fused.physics_step_fused(model, params, q, qd, qfrc, xfrc=xfrc, q_target=q_target, dyn=dyn)
        assert _cuda.FusedStepCall.launches == before + 1
        po = plain(rows(q), rows(qd), rows(qfrc), xr, rows(q_target), dyn_rows)
        torch.cuda.synchronize()
        ref = {"q": po[0].T, "qd": po[1].T,
               "body_force": po[2].reshape(3, nb, n).permute(2, 1, 0),
               "body_torque": po[3].reshape(3, nb, n).permute(2, 1, 0),
               "dof_force": po[4].T}
        for k, t in tol.items():
            assert float((getattr(ko, k) - ref[k]).abs().max()) < t, k
        force = max(force, float(ko.body_force.abs().max()))
        q, qd = ref["q"].contiguous(), ref["qd"].contiguous()
    return force


def _task(name, n):
    from isaacgymenvs_tpu_torch.utils.config import load_config

    return task_map[name](load_config([f"task={name}", f"num_envs={n}"])["task"], device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Ingenuity", "Quadcopter"])
def test_copter_kernels_match_plain_version(name):
    """Ingenuity (24 plane rows, xfrc) and Quadcopter (44 plane rows: two
    contacts per lane; xfrc and q_target) at a ragged N = 37, a third of the
    envs lowered onto the ground so that plane rows are active."""
    _needs_card()
    n = 37
    env = _task(name, n)
    m = env.model
    state, _ = env.reset(1)
    rng = np.random.RandomState(2)
    cuda = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    q = state.sim.q.clone()
    # chassis heights at which the lowest candidate points rest up to 1 mm
    # in the ground (a deep start is pushed out in the first slice and the
    # sensors of the last slice read nothing)
    lo, hi = {"Ingenuity": (0.059, 0.06), "Quadcopter": (0.014, 0.015)}[name]
    q[::3, 2] = cuda(rng.uniform(lo, hi, len(q[::3])))
    # gentle inputs: a Quadcopter rotor arm weighs under a gram
    qd = cuda(rng.uniform(-0.1, 0.1, (n, m.nv)))
    qd[::3] = 0.0
    qfrc = cuda(rng.uniform(-0.02, 0.02, (n, m.nv)))
    xfrc = cuda(rng.uniform(-0.02, 0.02, (n, m.nbody, 6)))
    qt = q + cuda(rng.uniform(-0.1, 0.1, q.shape)) if env.use_pd_targets else None
    force = _held_against_plain(m, env.sim_params, q, qd, qfrc, xfrc, qt, 3, TOL)
    assert force > 0.1  # ground contacts were active


@pytest.mark.cuda
def test_ball_balance_kernel_matches_plain_version():
    """BallBalance (21 plane rows, the ball-vs-tray cylinder pair row, three
    anchors, q_target; nv 18) with the ball resting on the tray, so the pair
    row is active: the tray's body force must be non-zero. q 5e-4, the other
    tolerances as everywhere."""
    _needs_card()
    n = 37
    env = _task("BallBalance", n)
    m = env.model
    rng = np.random.RandomState(3)
    cuda = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    q = env.qpos0.repeat(n, 1)
    bq = env.ball_q
    q[:, bq:bq + 2] = cuda(rng.uniform(-0.2, 0.2, (n, 2)))
    q[:, bq + 2] = env.tray_height + 0.01 + env.ball_radius - 0.002
    qd = torch.zeros(n, m.nv, device="cuda")
    qfrc = cuda(rng.uniform(-0.5, 0.5, (n, m.nv)))
    qt = q + cuda(rng.uniform(-0.02, 0.02, q.shape))
    plain = fused._step_math_torch(fused._extract(m), env.sim_params, torch.device("cuda"))
    tray = plain(q.T.contiguous(), qd.T.contiguous(), qfrc.T.contiguous(), None, qt.T.contiguous())[2]
    pressed = tray.reshape(3, m.nbody, n)[2, env.tray_body].abs() > 1.0  # newtons
    assert float(pressed.float().mean()) > 0.5  # where the drive drops the tray, the ball is in free fall
    _held_against_plain(m, env.sim_params, q, qd, qfrc, None, qt, 3, {**TOL, "q": 5e-4})


@pytest.mark.cuda
def test_box_and_sphere_pair_rows_match_plain_version():
    """The example model's three pair rows (point vs BOX twice, point vs
    SPHERE), all active."""
    _needs_card()
    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import pair_row_example, pair_row_example_state

    n = 37
    m = pair_row_example()
    p = SimParams(dt=1 / 60, substeps=2, solver_apgd_iterations=16, contact_margin=0.02)
    q, qd = (torch.tensor(a, device="cuda") for a in pair_row_example_state(m, n, 1))
    rng = np.random.RandomState(4)
    cuda = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    qfrc = cuda(rng.uniform(-0.3, 0.3, (n, m.nv)))
    xfrc = cuda(rng.uniform(-0.2, 0.2, (n, m.nbody, 6)))
    force = _held_against_plain(m, p, q, qd, qfrc, xfrc, None, 3, TOL)
    assert force > 1.0


# ---- per-env leaves and tendons ---------------------------------------------


def _packed(model, names, n, seed, gravity):
    from isaacgymenvs_tpu_torch.model.examples import random_leaves

    leaves = random_leaves(model, names, n, seed, gravity)
    return fused.pack_dyn(fused._extract(model), {k: torch.tensor(v, device="cuda") for k, v in leaves.items()})


def _differs_without_leaves(model, params, q, qd, qfrc, dyn, **kw):
    """The step with per-env leaves must not equal the step without."""
    a = fused.physics_step_fused(model, params, q, qd, qfrc, dyn=dyn, **kw)
    b = fused.physics_step_fused(model, params, q, qd, qfrc, **kw)
    assert float((a.qd - b.qd).abs().max()) > 1e-3


ANT_YAML_LEAVES = ("body_mass", "dof_damping", "dof_stiffness", "dof_limit_lower", "dof_limit_upper")


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", ["yaml", "all"])
def test_ant_kernel_with_per_env_leaves_matches_plain_version(leaves):
    """Ant with the five leaves its yaml randomizes, and with every leaf
    that has rows on it plus gravity, at a ragged N = 37 with xfrc."""
    _needs_card()
    n = 37
    env = _ant(n, "cuda")
    m, p = env.model, env.sim_params
    names = ANT_YAML_LEAVES if leaves == "yaml" else fused.dyn_names(fused._extract(m), fused.DYN_ORDER)
    assert len(names) == (5 if leaves == "yaml" else 14)  # no tendon leaves on the Ant
    dyn = _packed(m, names, n, 5, p.gravity)
    state, _ = env.reset(1)
    rng = np.random.RandomState(2)
    qfrc = torch.tensor(rng.uniform(-3, 3, (n, m.nv)).astype(np.float32), device="cuda")
    xfrc = torch.tensor(rng.uniform(-1, 1, (n, m.nbody, 6)).astype(np.float32), device="cuda")
    _differs_without_leaves(m, p, state.sim.q, state.sim.qd, qfrc, dyn, xfrc=xfrc)
    _held_against_plain(m, p, state.sim.q, state.sim.qd, qfrc, xfrc, None, 3, TOL, dyn=dyn)


@pytest.mark.cuda
@pytest.mark.parametrize("with_leaves", [False, True], ids=["tendon_only", "all_leaves"])
def test_tendon_example_kernel_matches_plain_version(with_leaves):
    """The tendon example model (a fixed tendon, restitution on plane rows, a
    point-vs-box pair row): tendons alone, and with all fifteen leaves and
    gravity per env."""
    _needs_card()
    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import tendon_chain_example, tendon_chain_example_state

    n = 37
    m = tendon_chain_example()
    p = SimParams(dt=1 / 60, substeps=2, solver_apgd_iterations=16, contact_margin=0.02)
    q, qd = tendon_chain_example_state(m, n, 1)
    qd[::2, 2] = -0.6  # the box comes down faster than the bounce threshold
    cuda = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    q, qd = cuda(q), cuda(qd)
    rng = np.random.RandomState(4)
    qfrc = cuda(rng.uniform(-0.3, 0.3, (n, m.nv)))
    xfrc = cuda(rng.uniform(-0.2, 0.2, (n, m.nbody, 6)))
    dyn = _packed(m, fused.DYN_ORDER, n, 6, p.gravity) if with_leaves else None
    if with_leaves:
        assert dyn.names == fused.DYN_ORDER and dyn.rows.shape == (151, n)
        _differs_without_leaves(m, p, q, qd, qfrc, dyn, xfrc=xfrc)
    force = _held_against_plain(m, p, q, qd, qfrc, xfrc, None, 3, TOL, dyn=dyn)
    assert force > 1.0


@pytest.mark.cuda
def test_ball_balance_kernel_with_pair_row_leaves_matches_plain_version():
    """BallBalance with per-env cpoint_friction, cpoint_pos, geom_size and
    body_mass: the sites a pair row reads."""
    _needs_card()
    n = 37
    env = _task("BallBalance", n)
    m = env.model
    rng = np.random.RandomState(3)
    cuda = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    q = env.qpos0.repeat(n, 1)
    bq = env.ball_q
    q[:, bq:bq + 2] = cuda(rng.uniform(-0.2, 0.2, (n, 2)))
    q[:, bq + 2] = env.tray_height + 0.01 + env.ball_radius - 0.002
    qd = torch.zeros(n, m.nv, device="cuda")
    qfrc = cuda(rng.uniform(-0.5, 0.5, (n, m.nv)))
    qt = q + cuda(rng.uniform(-0.02, 0.02, q.shape))
    dyn = _packed(m, ("cpoint_friction", "cpoint_pos", "geom_size", "body_mass"), n, 7, env.sim_params.gravity)
    _differs_without_leaves(m, env.sim_params, q, qd, qfrc, dyn, q_target=qt)
    force = _held_against_plain(m, env.sim_params, q, qd, qfrc, None, qt, 3, {**TOL, "q": 5e-4}, dyn=dyn)
    assert force > 1.0


@pytest.mark.cuda
def test_wrong_leaf_set_raises_on_card():
    """A prepared instantiation refuses another set of per-env rows; nothing
    falls back to the plain version."""
    _needs_card()
    env = _ant(4, "cuda")
    m, p = env.model, env.sim_params
    s = fused._extract(m)
    step = _cuda.FusedStepCall(s, p, fused.apgd_betas(p.solver_apgd_iterations), torch.device("cuda"),
                               names=("body_mass",))
    rows = lambda r: torch.zeros(r, 4, device="cuda")
    with pytest.raises(ValueError, match="per-env leaves"):
        step(rows(m.nq), rows(m.nv), rows(m.nv), None)
    with pytest.raises(ValueError, match="shape"):
        step(rows(m.nq), rows(m.nv), rows(m.nv), None, None, rows(m.nbody + 1))


def _anymal(key, n):
    """Anymal, AnymalTerrain, or AnymalTerrain on its plane, at n envs on the card."""
    from isaacgymenvs_tpu_torch.utils.config import load_config

    args = {"Anymal": ["task=Anymal"], "AnymalTerrain": ["task=AnymalTerrain"],
            "AnymalTerrain-plane": ["task=AnymalTerrain", "task.env.terrain.terrainType=plane"]}[key]
    task = args[0].split("=")[1]
    return task_map[task](load_config([*args, f"num_envs={n}"])["task"], device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["Anymal", "AnymalTerrain", "AnymalTerrain-plane"])
def test_anymal_kernels_match_plain_version(key):
    """One env step's physics call of each Anymal instantiation (the merged
    window of 4 slices with warm resets for AnymalTerrain, its top-K cap of
    20, terrain rows and the friction leaf) against `_step_math_torch`, the
    robots standing within 2 m of the world origin (on AnymalTerrain the grid
    is moved so that the corner of its cell (1, 1) lies there), the lowest
    candidate 1 mm in the ground; TOL as above."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine.dynamics import Terrain, forward_kinematics

    _needs_card()
    n = 37
    env = _anymal(key, n)
    m = env.model
    state, _ = env.reset(2)
    q, qd = state.sim.q.clone(), torch.zeros(n, m.nv, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    q[:, :2] = 4.0 * torch.rand(n, 2, generator=g, device="cuda") - 2.0
    terrain = None
    if env.terrain is not None:
        corner = (env.grid.border + round(env.grid.env_length / env.grid.hs)) * env.grid.hs
        terrain = Terrain(env.terrain.height, env.grid.hs, origin=(-corner, -corner))
    cb = torch.tensor(m.cpoint_body, device="cuda")
    kin = forward_kinematics(m, q, qd)
    x = kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], torch.tensor(np.asarray(m.cpoint_pos), device="cuda"))
    ground = terrain.sample(x[..., :2]) if terrain is not None else 0.0
    q[:, 2] -= (x[..., 2] - torch.tensor(np.asarray(m.cpoint_radius), device="cuda") - ground).amin(1) + 0.001
    qt = q + 0.05 * (torch.rand(q.shape, generator=g, device="cuda") - 0.5)
    p, wre = (env._merged_params, env._warm_reset_every) if env.merge_slices else (env.sim_params, 0)
    terr = None if terrain is None else fused.pack_terrain(fused.terrain_dyn(m, terrain, q, qd))
    dyn = state.dyn
    before = _cuda.FusedStepCall.launches
    ko = fused.physics_step_fused(m, p, q, qd, torch.zeros_like(qd), q_target=qt, dyn=dyn, terrain=terr,
                                  warm_reset_every=wre)
    assert _cuda.FusedStepCall.launches == before + 1
    plain = fused._step_math_torch(fused._extract(m), p, torch.device("cuda"), dyn.names if dyn is not None else ())
    rows = lambda a: a.T.contiguous()
    po = plain(rows(q), rows(qd), rows(torch.zeros_like(qd)), None, rows(qt),
               None if dyn is None else dyn.rows, terr, wre)
    torch.cuda.synchronize()
    nb = m.nbody
    ref = {"q": po[0].T, "qd": po[1].T, "body_force": po[2].reshape(3, nb, n).permute(2, 1, 0),
           "body_torque": po[3].reshape(3, nb, n).permute(2, 1, 0), "dof_force": po[4].T}
    for k, tol in TOL.items():
        assert float((getattr(ko, k) - ref[k]).abs().max()) < tol, k
    assert float(ko.body_force[:, :, 2].sum(1).min()) > 1.0  # every robot stands on the ground


@pytest.mark.cuda
def test_sdf_rows_kernel_matches_plain_version():
    """K6 SDF rows on the card: the ball on an SDF box (N=37) and
    FactoryTaskInsertion at eight envs per block (N=9, a part-full last block,
    the cap of 32 binding in the envs whose plug lies against the socket)
    against the plain version, the SDF planes sampled at the entry pose."""
    _needs_card()
    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import ball_on_sdf_box
    from isaacgymenvs_tpu_torch.utils.config import load_config

    rows = lambda t: t.T.contiguous()
    m = ball_on_sdf_box()
    q = torch.tensor(m.qpos0, device="cuda").repeat(37, 1)
    q[:, 2] = 0.4495
    cases = [(m, SimParams(dt=1 / 60, substeps=2), q, torch.zeros(37, m.nv, device="cuda"), None, None, None)]
    env = task_map["FactoryTaskInsertion"](load_config(["task=FactoryTaskInsertion", "num_envs=9"])["task"],
                                          device="cuda")
    q, qd = env.contact_states(9, 0)
    qfrc, xfrc, qt = env.compute_force(None, q, qd, {"q_ref": q[:, env.q_idx]})
    cases.append((env.model, env.sim_params, q, qd, qfrc, xfrc, qt))
    for m, p, q, qd, qfrc, xfrc, qt in cases:
        n, s = q.shape[0], fused.spec_of(m)
        qfrc = torch.zeros(n, m.nv, device="cuda") if qfrc is None else qfrc
        sdf = fused.pack_sdf(fused.sdf_dyn(m, q, qd))
        before = _cuda.FusedStepCall.launches
        out = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=qt, sdf=sdf)
        assert _cuda.FusedStepCall.launches == before + 1
        xf = None if xfrc is None else xfrc.permute(2, 1, 0).reshape(6 * m.nbody, n).contiguous()
        ref = fused._step_math_torch(s, p, q.device)(rows(q), rows(qd), rows(qfrc), xf,
                                                      None if qt is None else rows(qt), None, None, 0, sdf)
        got = (out.q.T, out.qd.T, out.body_force.permute(2, 1, 0).reshape(3 * m.nbody, n),
               out.body_torque.permute(2, 1, 0).reshape(3 * m.nbody, n), out.dof_force.T)
        for k, a, b in zip(TOL, got, ref):
            assert float((a - b).abs().max()) < TOL[k], k


@pytest.mark.cuda
def test_humanoid_kernel_matches_plain_version():
    """The Humanoid instantiation (nv 27, 35 plane contacts, 8 envs per
    block) against its plain version for one step at 256 envs, from
    well-conditioned standing states (chip_smoke.humanoid_inputs): within
    the tolerances, both feet carrying force in 90 % of the envs or more."""
    import pathlib
    import sys

    _needs_card()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    env = _task("Humanoid", 256)
    (q, qd, qfrc, xfrc), _ = chip_smoke.humanoid_inputs(env, 256, seed=71, steps=1)
    _, step = fused._prepared(env.model, env.sim_params, torch.device("cuda"))
    assert step.sizes == (25, 28, 27, 35, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 8)
    before = _cuda.FusedStepCall.launches
    err = chip_smoke.compare_model(env.model, env.sim_params, q, qd, qfrc, xfrc, None, 1,
                                   force_of=env.feet.tolist())
    assert _cuda.FusedStepCall.launches == before + 1 and err["seen_force"] > 0.9
    assert step.occupancy()["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_humanoid_amp_kernel_matches_plain_version():
    """The HumanoidAMP instantiation (nv 34: two dofs per lane, five k-tiles
    of the Gram product; 42 plane contacts under the top-K cap of 16,
    q_target; 8 envs per block) against its plain version for 3 env steps
    (6 calls) at 512 envs, from `chip_smoke.amp_inputs` (states of the clip,
    and one in 32 lying on its back past the cap), within the tolerances."""
    import pathlib
    import sys

    _needs_card()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    env = _task("HumanoidAMP", 512)
    (q, qd, qt), _, past = chip_smoke.amp_inputs(env, 512, seed=73)
    _, step = fused._prepared(env.model, env.sim_params, torch.device("cuda"), True)
    assert step.sizes == chip_smoke.AMP_SIZES and past == 512 // chip_smoke.PAST_CAP_SHARE
    before = _cuda.FusedStepCall.launches
    zero = torch.zeros(512, env.model.nv, device="cuda")
    chip_smoke.compare_model(env.model, env.sim_params, q, qd, zero, None, qt, chip_smoke.AMP_LAUNCHES)
    assert _cuda.FusedStepCall.launches == before + chip_smoke.AMP_LAUNCHES
    assert step.occupancy()["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["FrankaCubeStack", "FrankaCabinet"])
def test_franka_kernels_match_plain_version(task):
    """Rows 1v and 1w: FrankaCubeStack (nv 21, 40 BOX pair rows under the
    top-K cap of 20, two free cubes, q_target) and FrankaCabinet (nv 13, 24
    pair rows against a MESH handle on the cylinder branch under the cap of
    16, finger drives of stiffness 1e6) against their plain versions for 3
    env steps at 512 envs, from `chip_smoke.franka_inputs` (the tasks'
    contact states under FrankaCubeStack's OSC torques, kept where rounding
    alone moves each call by at most COND_TOL), within the tolerances."""
    import pathlib
    import sys

    _needs_card()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    env = _task(task, 512)
    (q, qd, qfrc, qt), _, _ = chip_smoke.franka_inputs(env, 512, seed=75)
    _, step = fused._prepared(env.model, env.sim_params, torch.device("cuda"), True)
    assert step.sizes[:14] == chip_smoke.FRANKA_SIZES[task]
    before = _cuda.FusedStepCall.launches
    chip_smoke.compare_model(env.model, env.sim_params, q, qd, qfrc, None, qt, chip_smoke.FRANKA_LAUNCHES)
    assert _cuda.FusedStepCall.launches == before + chip_smoke.FRANKA_LAUNCHES
    assert step.occupancy()["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace", "FactoryTaskNutBoltScrew"])
def test_nut_bolt_kernels_match_plain_version(task):
    """Rows 1x-1z: the nut-bolt family (nv 17; 144, 100 or 72 plane rows
    and as many SDF rows against two grids, the free nut's and that of the
    bolt on its two slides, under the cap of 16; q_target, xfrc) against
    their plain versions for 3 env steps at 256 envs, from
    `chip_smoke.nutbolt_inputs` (the tasks' contact states under their own
    controllers, kept where rounding alone moves each call by at most
    COND_TOL), within the tolerances; the nut and the bolt take contact
    force."""
    import pathlib
    import sys

    _needs_card()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    n = 256
    env = _task(task, chip_smoke.NUTBOLT_ENVS)
    (q, qd), _, _ = chip_smoke.nutbolt_inputs(env, n, seed=77)
    m, p = env.model, env.sim_params
    _, step = fused._prepared(m, p, torch.device("cuda"), True)
    assert step.sizes[:14] == chip_smoke.NUTBOLT_SIZES[task]
    plain = fused._step_math_torch(step.s, p, torch.device("cuda"))
    before = _cuda.FusedStepCall.launches
    x = (q, qd)
    for call in range(chip_smoke.NUTBOLT_LAUNCHES):
        qfrc, xfrc, qt, sdf = chip_smoke.nutbolt_calls(env, *x)
        ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, sdf=sdf)
        po = plain(*(t.T.contiguous() for t in (x[0], x[1], qfrc)), chip_smoke.xfrc_rows(xfrc), qt.T.contiguous(),
                   None, None, 0, sdf)
        chip_smoke.compare_outputs(f"{task} call {call}", ko, po, m.nbody, n)
        if call == 0:
            force = torch.linalg.vector_norm(ko.body_force, dim=-1)
            assert float((force[:, env.nut_ref.body0] > 0.05).float().mean()) >= 0.9
            assert float((force[:, env.bolt_body] > 0.05).float().mean()) >= 0.25
        x = (po[0].T.contiguous(), po[1].T.contiguous())
    assert _cuda.FusedStepCall.launches == before + chip_smoke.NUTBOLT_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["IndustRealTaskPegsInsert", "IndustRealTaskGearsInsert"])
def test_industreal_kernels_match_plain_version(task):
    """The IndustReal builds: PegsInsert (nv 19, 88 plane rows and 88 SDF
    rows against two grids, the socket's on three slides and a yaw hinge and
    the free plug's, under the cap of 32) and GearsInsert (114 + 114 rows,
    three grids, under the cap of 64: more slots than a warp has lanes)
    against their plain versions for 3 env steps at 256 envs, from
    `chip_smoke.industreal_inputs` (the tasks' contact states under their
    task-space impedance at zero actions, kept where rounding alone moves
    each call by at most COND_TOL; Gears only states with 33 rows or more
    in the margin), within the tolerances."""
    import pathlib
    import sys

    _needs_card()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    n = 256
    env = _task(task, chip_smoke.INDUSTREAL_ENVS)
    gears = "Gears" in task
    (q, qd), _, (_, _, fewest) = chip_smoke.industreal_inputs(
        env, n, seed=79, calls=3, min_active=chip_smoke.GEARS_MIN_ACTIVE if gears else 0)
    assert fewest >= (chip_smoke.GEARS_MIN_ACTIVE if gears else 0)
    m, p = env.model, env.sim_params
    _, step = fused._prepared(m, p, torch.device("cuda"), True)
    assert step.sizes[:14] == chip_smoke.INDUSTREAL_SIZES[task] and step.epb == (4 if gears else 8)
    plain = fused._step_math_torch(step.s, p, torch.device("cuda"))
    before = _cuda.FusedStepCall.launches
    x = (q, qd)
    for call in range(3):
        qfrc, xfrc, qt, sdf = chip_smoke.industreal_calls(env, *x)
        ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, sdf=sdf)
        po = plain(*(t.T.contiguous() for t in (x[0], x[1], qfrc)), chip_smoke.xfrc_rows(xfrc), qt.T.contiguous(),
                   None, None, 0, sdf)
        chip_smoke.compare_outputs(f"{task} call {call}", ko, po, m.nbody, n)
        x = (po[0].T.contiguous(), po[1].T.contiguous())
    assert _cuda.FusedStepCall.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["Trifinger", "ShadowHand", "AllegroHand", "ShadowHandOpenAI_FF"])
def test_hand_kernels_match_plain_version(task):
    """The hand builds: Trifinger (nv 15, 11 plane rows and 3 pair rows, no
    cap, its yaml's 8 per-env leaves and gravity), ShadowHand (nv 30, 114
    pair rows under the cap of 24, 4 tendons, q_target), AllegroHand
    (nv 22, 144 pair rows under the cap of 24, q_target, 2 control slices)
    and ShadowHand under ShadowHandOpenAI_FF.yaml (its 13 per-env leaves,
    a random force on the object, 3 control slices)
    against their plain versions for 2 env steps at 256 envs, from
    `chip_smoke.hand_inputs` (the tasks' contact states under
    `chip_smoke.hand_calls`, kept where rounding alone moves each call by at
    most COND_TOL), within the tolerances."""
    import pathlib
    import sys

    _needs_card()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    n = 256
    env = chip_smoke.hand_env(task, 64)
    calls = 2 * env.control_freq_inv
    (q, qd), dyn, _, _ = chip_smoke.hand_inputs(env, n, seed=83, calls=calls)
    m, p = env.model, env.sim_params
    names = () if dyn is None else dyn.names
    _, step = fused._prepared(m, p, torch.device("cuda"), env.use_pd_targets, names)
    assert step.sizes[:14] == chip_smoke.HAND_SIZES[task]
    plain = fused._step_math_torch(step.s, p, torch.device("cuda"), names)
    before = _cuda.FusedStepCall.launches
    x = (q, qd)
    for call in range(calls):
        qfrc, xfrc, qt = chip_smoke.hand_calls(env, *x)
        ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, dyn=dyn)
        po = plain(x[0].T.contiguous(), x[1].T.contiguous(), qfrc.T.contiguous(), chip_smoke.xfrc_rows(xfrc),
                   None if qt is None else qt.T.contiguous(), None if dyn is None else dyn.rows)
        chip_smoke.compare_outputs(f"{task} call {call}", ko, po, m.nbody, n)
        x = (po[0].T.contiguous(), po[1].T.contiguous())
    assert _cuda.FusedStepCall.launches == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["AllegroKukaReorientation", "AllegroKukaTwoArmsReorientation", "AllegroKuka+dr"])
def test_allegro_kuka_kernels_match_plain_version(key):
    """The AllegroKuka builds: one arm (nv 29, 32 pair rows, no cap,
    q_target), two arms (nv 52 on two dofs per lane, 56 pair rows, no cap)
    and the one arm under its yaml's domain randomization (10 per-env
    leaves and gravity) against their plain versions for 2 env steps at 256
    envs, from `chip_smoke.kuka_inputs` (the cube on a fingertip or on the
    table under `chip_smoke.kuka_calls`, kept where rounding alone moves
    each call by at most COND_TOL), within the tolerances."""
    import pathlib
    import sys

    _needs_card()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    n = 256
    dr = key == chip_smoke.KUKA_DR
    env = chip_smoke.hand_env("AllegroKukaReorientation" if dr else key, 64,
                              ("task.task.randomize=True",) if dr else ())
    (q, qd), dyn, _ = chip_smoke.kuka_inputs(env, n, seed=85, calls=2)
    m, p = env.model, env.sim_params
    names = () if dyn is None else dyn.names
    _, step = fused._prepared(m, p, torch.device("cuda"), True, names)
    assert step.sizes[:14] == chip_smoke.KUKA_SIZES[key]
    plain = fused._step_math_torch(step.s, p, torch.device("cuda"), names)
    before = _cuda.FusedStepCall.launches
    x = (q, qd)
    for call in range(2):
        qfrc, xfrc, qt = chip_smoke.kuka_calls(env, *x)
        ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, dyn=dyn)
        po = plain(x[0].T.contiguous(), x[1].T.contiguous(), qfrc.T.contiguous(), chip_smoke.xfrc_rows(xfrc),
                   qt.T.contiguous(), None if dyn is None else dyn.rows)
        chip_smoke.compare_outputs(f"{key} call {call}", ko, po, m.nbody, n)
        x = (po[0].T.contiguous(), po[1].T.contiguous())
    assert _cuda.FusedStepCall.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["AllegroHandDextremeADR", "AllegroHandDextremeManualDR"])
def test_dextreme_kernel_matches_plain_version(task):
    """AllegroHand's build (nv 22, 144 pair rows under the cap of 24,
    q_target, 2 control slices) under each DeXtreme yaml's per-env leaves
    (the ADR yaml's drawn through ADR's overrides, each physics parameter
    pinned at both edges in some envs, `chip_smoke.dextreme_overrides`; the
    restitution turns the pair rows' bounce on), against its plain version
    for 2 env steps at 256 envs from `chip_smoke.hand_inputs`, within the
    tolerances."""
    import pathlib
    import sys

    _needs_card()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    n = 256
    env = chip_smoke.hand_env(task, 64)
    calls = 2 * env.control_freq_inv
    (q, qd), dyn, _, _ = chip_smoke.hand_inputs(env, n, seed=89, calls=calls)
    m, p = env.model, env.sim_params
    _, step = fused._prepared(m, p, torch.device("cuda"), True, dyn.names)
    assert step.sizes[:8] == chip_smoke.HAND_SIZES["AllegroHand"][:8] and step.sizes[8]
    assert "cpoint_restitution" in dyn.names
    plain = fused._step_math_torch(step.s, p, torch.device("cuda"), dyn.names)
    before = _cuda.FusedStepCall.launches
    x = (q, qd)
    for call in range(calls):
        qfrc, xfrc, qt = chip_smoke.hand_calls(env, *x)
        ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, dyn=dyn)
        po = plain(x[0].T.contiguous(), x[1].T.contiguous(), qfrc.T.contiguous(), chip_smoke.xfrc_rows(xfrc),
                   qt.T.contiguous(), dyn.rows)
        chip_smoke.compare_outputs(f"{task} call {call}", ko, po, m.nbody, n)
        x = (po[0].T.contiguous(), po[1].T.contiguous())
    assert _cuda.FusedStepCall.launches == before + calls
