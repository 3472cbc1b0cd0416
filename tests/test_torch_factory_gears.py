"""The port's FactoryTaskGears against the JAX package, on the CPU, on both
of its routes.

The gears and the base are the stand-ins written by
assets/factory/make_gears_meshes.py; the JAX package reads them through
$ISAACGYMENVS_TPU_ASSETS. The port's default route is the kernel (here its
plain version), held against JAX's fused math (`use_fused: True` and
`_fused_cap_cache = True` on the JAX instance: its TPU screen refuses the
model for VMEM only); its route under `sim.use_fused: False` is the eager
engine, held against the JAX env's eager engine (its CPU default).
Tolerances: models equal within 1e-6; env steps q 2e-4, qd 2e-3 (the
tolerances of tests/test_fused.py:79-82), each step from the JAX state
(on the kernel route JAX's step through its fused math runs op by op,
`_jax_fused_env_step`: its jit of the unrolled math takes two minutes);
observations and rewards exactly zero on both sides.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.convert import env_state_from_arrays
from isaacgymenvs_tpu_torch.engine import _cuda
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from test_torch_factory import _assert_models_equal

torch.set_num_threads(1)

N = 4
TASK = "FactoryTaskGears"
FACTORY = os.path.join(package_asset_root(), "factory")
_ENVS = {}


def _both(route, extra=()):
    """(JAX env, port env) at N envs, built once per worker and route:
    "kernel" (JAX's fused math, the port's default) or "eager" (JAX's CPU
    default, the port under sim.use_fused=False)."""
    key = (route, tuple(extra))
    if key not in _ENVS:
        from isaacgymenvs_tpu.tasks import task_map as jtasks
        from isaacgymenvs_tpu.utils.config import load_config as jload
        from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
        from isaacgymenvs_tpu_torch.utils.config import load_config as tload

        args = [f"task={TASK}", f"num_envs={N}", *extra]
        jcfg, tcfg = jload(args)["task"], tload(args)["task"]
        if route == "kernel":
            jcfg["sim"]["use_fused"] = True
        else:
            tcfg["sim"]["use_fused"] = False
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
            jenv = jtasks[TASK](jcfg)
            if route == "kernel":
                jenv._fused_cap_cache = True
            _ENVS[key] = (jenv, ttasks[TASK](tcfg, device="cpu"))
    return _ENVS[key]


def test_meshes_are_the_scripts_output_and_give_jaxs_points(tmp_path, monkeypatch):
    """The four committed OBJ files are what make_gears_meshes.py writes, and
    every mesh is closed (each edge in two faces, the two ways round). The
    gears' 40 contact points each equal JAX's `gear_template_points`; they
    lie on the tips, 10 on the bottom rim at z = 5 mm; the centroids lie on
    the axes the task's centres of mass take (x 0.0505 / 0.0202 / -0.0302,
    within 0.5 mm of 0.0508 / 0.0202 / -0.0302) and the small gear spans x
    from 39.5 to 61.5 mm."""
    from isaacgymenvs_tpu.tasks import factory_templates as jft
    from isaacgymenvs_tpu_torch.sdf.builder import load_obj
    from isaacgymenvs_tpu_torch.tasks import factory_templates as tft

    spec = importlib.util.spec_from_file_location("make_gears_meshes", os.path.join(FACTORY, "make_gears_meshes.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    files = [os.path.join(gen.FACTORY, n) for n in ("factory_gear_small_space_5e-4.obj",
                                                    "factory_gear_medium_space_5e-4.obj",
                                                    "factory_gear_base_tight_space_5e-4_subdiv_4x.obj")]
    files.append(os.path.join(gen.INDUSTREAL, "industreal_gear_large.obj"))
    committed = [open(f).read() for f in files]
    monkeypatch.setattr(gen, "FACTORY", str(tmp_path / "f"))
    monkeypatch.setattr(gen, "INDUSTREAL", str(tmp_path / "i"))
    gen.main()
    fresh = [str(tmp_path / ("i" if "industreal" in f else "f") / os.path.basename(f)) for f in files]
    assert [open(f).read() for f in fresh] == committed
    for f in files:
        v, t = load_obj(f)
        edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        fwd = {tuple(e) for e in edges.tolist()}
        assert len(fwd) == len(edges) and all((b, a) in fwd for a, b in fwd), f
    monkeypatch.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
    for size, (_, tip, cx) in gen.GEARS.items():
        pts = tft.gear_template_points(size)
        np.testing.assert_array_equal(pts, jft.gear_template_points(size))
        assert pts.shape == (40, 3)
        np.testing.assert_allclose(np.hypot(pts[:, 0] - cx, pts[:, 1]), tip, atol=1e-6)
        assert int((np.abs(pts[:, 2] - 0.005) < 1e-7).sum()) == 10
        assert abs(cx - tft.GEAR_SPECS[size][2]) < 5e-4
    v, _ = load_obj(files[0])
    assert abs(v[:, 0].min() - 0.0395) < 1e-4 and abs(v[:, 0].max() - 0.0615) < 1e-4


def test_gears_model_matches_jax():
    """`compose` of the Franka, three gears and the base, the stripped
    candidate points, 3 x 40 gear points, the base's SDF grid (192 voxels
    along its longest side) and the pairs: every leaf equal to JAX's; nbody
    16, nq 30, nv 27, 120 plane and 120 SDF rows under the cap of 96. The
    kernel covers it at 91,792 bytes of shared memory at one env per block
    and 142,656 at two (its choice): the default route is the kernel."""
    jenv, tenv = _both("kernel")
    _assert_models_equal(tenv.model, jenv.model)
    m, p = tenv.model, tenv.sim_params
    assert (m.nbody, m.nq, m.nv, m.ncp, len(m.spair_point)) == (16, 30, 27, 120, 120)
    assert [tuple(r) for r in tenv.gear_refs] == [tuple(r) for r in jenv.gear_refs]
    assert m.sdf_body == (tenv.base_ref.body0,) and m.sdf_values[0].shape == (192, 77, 49)
    s = tfused.spec_of(m)
    assert s.nct == 240 and tfused.topk_cap(s, p) == 96 and p.solver_apgd_iterations == 64
    assert tfused.unsupported_features(m, p) == [] and tenv.physics_route == "kernel"
    smem = {e: _cuda.smem_bytes(s, p, e, has_qt=True) for e in (1, 2)}
    assert smem == {1: 91792, 2: 142656}
    assert _cuda.envs_per_block(lambda e: _cuda.smem_bytes(s, p, e, has_qt=True), _cuda.SMEM_OPTIN_BYTES,
                                _cuda.plan_regs(s.nv)) == 2
    _, teager = _both("eager")
    assert teager.physics_route == "eager"


def test_reset_matches_jax():
    """`initial_state: goal` with no joint noise draws nothing: both resets
    put the Franka at mid-range and every gear on its shaft, equal q; the
    random reset puts the small and large gear at y = 0.1 and the medium
    one at -0.1, each within 0.05 in x and y, upright on the table."""
    for extra in (("task.randomize.initial_state=goal",), ()):
        jenv, tenv = _both("eager", extra)
        jstate, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
        tstate, tobs = tenv.reset(0)
        assert not tobs.any()
        q = tstate.sim.q.numpy()
        if extra:
            np.testing.assert_array_equal(q, np.asarray(jstate.sim.q))
            continue
        for ref, y in zip(tenv.gear_refs, (0.1, -0.1, 0.1)):
            a = tenv.model.q_adr[ref.body0]
            for qq in (q, np.asarray(jstate.sim.q)):
                assert (np.abs(qq[:, a]) <= 0.05).all() and (np.abs(qq[:, a + 1] - y) <= 0.05).all()
                np.testing.assert_array_equal(qq[:, a + 2:a + 7], np.tile([0, 0, 0, 0, 1.0], (N, 1)))
        np.testing.assert_allclose(tstate.task["q_ref"].numpy(), np.asarray(jstate.task["q_ref"]), atol=1e-7)


def _fields(js):
    return {"q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf,
            "actions": js.actions, "task": {k: np.asarray(v) for k, v in js.task.items()}}


@pytest.mark.parametrize("route", ["kernel", "eager"])
def test_env_steps_match_jax(route):
    """From the port's `contact_states` (every gear on the table, or every
    gear on its shaft on the plate, in turn) put on both, three env steps
    under random actions (stored, never applied), each from the JAX state:
    q 2e-4, qd 2e-3; observations and rewards zero; done flags equal. The
    gears take contact force: their rows act."""
    jenv, tenv = _both(route)
    assert tenv.physics_route == route
    q, qd = tenv.contact_states(N, seed=3)
    jstate, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q.numpy()), qd=jnp.asarray(qd.numpy())),
                            task={"q_ref": jnp.asarray(q[:, tenv.q_idx].numpy())})
    tstate, _ = tenv.reset(0)
    jstep = jax.jit(jenv.step) if route == "eager" else _jax_fused_env_step(jenv)
    rng = np.random.RandomState(4)
    moved = 0.0
    for _ in range(3):
        tstate = env_state_from_arrays(tstate, _fields(jstate), "cpu")
        a = rng.uniform(-1, 1, (N, 12)).astype(np.float32)
        q0 = np.asarray(jstate.sim.q)
        jstate, jobs, jrew, jdone, _ = jstep(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, _ = tenv.step(tstate, torch.tensor(a))
        assert not tobs.any() and not trew.any() and not np.asarray(jobs).any() and not np.asarray(jrew).any()
        np.testing.assert_allclose(tstate.sim.q.numpy(), np.asarray(jstate.sim.q), atol=2e-4)
        np.testing.assert_allclose(tstate.sim.qd.numpy(), np.asarray(jstate.sim.qd), atol=2e-3)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        moved = max(moved, float(np.abs(np.asarray(jstate.sim.q) - q0).max()))
    assert moved > 1e-4


def _jax_fused_env_step(jenv):
    """The JAX env's step on its fused path (`use_fused: True`) as its
    `step` takes it for this task, op by op (its jit compiles the unrolled
    fused math for two minutes): `compute_force`, the SDF planes at the
    step's entry pose (`sdf_dyn`), `physics_step_fused(use_pallas=False)`,
    then the progress and the template's zero observation and reward and
    its timeout (no env resets within the steps compared)."""
    from isaacgymenvs_tpu.engine import fused as jfused

    def step(state, actions):
        q, qd = state.sim.q, state.sim.qd
        qfrc, xfrc, qt = jax.vmap(jenv.compute_force)(actions, q, qd, state.task)
        out = jfused.physics_step_fused(jenv.model, jenv.sim_params, q, qd, qfrc, xfrc=xfrc, q_target=qt,
                                        use_pallas=False, dyn=jfused.sdf_dyn(jenv.model, q, qd))
        assert not np.asarray(state.reset_buf).any()
        progress = state.progress + 1
        new = state.replace(sim=state.sim.replace(q=out.q, qd=out.qd), progress=progress, actions=actions)
        done = progress >= jenv.max_episode_length - 1
        return new.replace(reset_buf=done), jnp.zeros((N, jenv.num_obs)), jnp.zeros(N), done, {}

    return step


@pytest.mark.parametrize("route", ["kernel", "eager"])
def test_template_contract(route):
    """tests/test_factory_templates.py:18-59 on the port, on each route:
    zero observation and reward over 20 steps of random actions, a finite
    state, the arm within 0.2 rad of its reset pose, and every gear's
    contact points above -5 mm (settled on or above the table)."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine import dynamics

    _, env = _both(route)
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
    m = env.model
    kin = dynamics.forward_kinematics(m, q, torch.zeros_like(qd))
    cb = np.asarray(m.cpoint_body)
    for ref in env.gear_refs:
        sel = np.where(cb == ref.body0)[0]
        b = ref.body0
        pts = kin.x[:, b:b + 1] + maths.quat_rotate(kin.quat[:, b:b + 1].expand(N, len(sel), 4),
                                                    torch.tensor(m.cpoint_pos[sel]).expand(N, len(sel), 3))
        assert float(pts[..., 2].min()) > -0.005
