"""The eager engine and FactoryTaskGears' kernel build on the card.

This file imports no JAX, so it also runs on the GPU machine:

    python -m pytest tests/test_torch_engine_card.py -m cuda --noconftest -p no:cacheprovider

The `cuda`-marked tests skip where there is no card; the others run on the
CPU. Tolerances: q 2e-4, qd 2e-3, forces 2e-2 (tests/test_fused.py:79-82).
"""
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.engine import _cuda, fused
from isaacgymenvs_tpu_torch.engine.dynamics import SimParams, SimState
from isaacgymenvs_tpu_torch.engine.step import physics_step
from isaacgymenvs_tpu_torch.model.examples import pair_row_example, pair_row_example_state
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.config import load_config

TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _gears(n, device, eager=False):
    cfg = load_config(["task=FactoryTaskGears", f"num_envs={n}"])["task"]
    if eager:
        cfg["sim"]["use_fused"] = False
    return task_map["FactoryTaskGears"](cfg, device=device)


def _outputs(out):
    return {"q": out.state.q, "qd": out.state.qd, "body_force": out.body_force, "body_torque": out.body_torque,
            "dof_force": out.dof_force}


def test_the_eager_route_launches_no_kernel():
    """Gears under sim.use_fused=False on the CPU: the route is eager and two
    env steps launch nothing and stay finite."""
    env = _gears(4, "cpu", eager=True)
    assert env.physics_route == "eager"
    before = _cuda.FusedStepCall.launches
    state, _ = env.reset(0)
    for _ in range(2):
        state, *_ = env.step(state, torch.zeros(4, env.num_acts))
    assert _cuda.FusedStepCall.launches == before and bool(torch.isfinite(state.sim.q).all())


def test_the_eager_step_in_float64_holds_float32():
    """The eager step in float32 within the tolerances of the same step in
    float64, on the pair-row example under PGS and APGD (CPU)."""
    m = pair_row_example()
    q, qd = (torch.tensor(a) for a in pair_row_example_state(m, 8, 3))
    for solver in ("apgd", "pgs"):
        p = SimParams(substeps=2, solver=solver, contact_margin=0.02)
        a = _outputs(physics_step(m, SimState(q, qd), torch.zeros_like(qd), p))
        b = _outputs(physics_step(m, SimState(q.double(), qd.double()), torch.zeros_like(qd).double(), p))
        for k, tol in TOL.items():
            assert a[k].dtype == torch.float32 and b[k].dtype == torch.float64
            assert float((a[k].double() - b[k]).abs().max()) < tol, (solver, k)


@pytest.mark.cuda
def test_eager_step_on_the_card_matches_the_cpu():
    """The pair-row example (APGD with a cap of 6, and PGS), three eager
    steps on the card against the same on the CPU."""
    _needs_card()
    m = pair_row_example()
    q, qd = (torch.tensor(a) for a in pair_row_example_state(m, 64, 5))
    for changes in ({"max_active_contacts": 6}, {"solver": "pgs"}):
        p = SimParams(substeps=2, contact_margin=0.02, **changes)
        c, g = (q, qd), (q.cuda(), qd.cuda())
        for _ in range(3):
            co = physics_step(m, SimState(*c), torch.zeros_like(c[1]), p)
            go = physics_step(m, SimState(*g), torch.zeros_like(g[1]), p)
            for k, tol in TOL.items():
                assert float((_outputs(go)[k].cpu() - _outputs(co)[k]).abs().max()) < tol, (changes, k)
            c, g = (co.state.q, co.state.qd), (co.state.q.cuda(), co.state.qd.cuda())


@pytest.mark.cuda
def test_gears_kernel_matches_its_plain_version_and_the_eager_route_runs():
    """Row 1ai (Gears: 240 rows under the cap of 96, two envs per block)
    against its plain version at 8 envs in its contact states for one env
    step's physics; then 3 eager env steps on the card, finite, without a
    launch."""
    _needs_card()
    env = _gears(8, "cuda")
    assert env.physics_route == "kernel"
    q, qd = env.contact_states(8, seed=3)
    qfrc, xfrc, qt = env.compute_force(None, q, qd, {"q_ref": q[:, env.q_idx]})
    sdf = fused.pack_sdf(fused.sdf_dyn(env.model, q, qd))
    ko = fused.physics_step_fused(env.model, env.sim_params, q, qd, qfrc, xfrc=xfrc, q_target=qt, sdf=sdf)
    s = fused.spec_of(env.model)
    rows = lambda t: t.T.contiguous()
    po = fused._step_math_torch(s, env.sim_params, torch.device("cuda"))(
        rows(q), rows(qd), rows(qfrc), xfrc.permute(2, 1, 0).reshape(6 * s.nbody, 8).contiguous(), rows(qt), None,
        None, 0, sdf)
    assert float((ko.q - po[0].T).abs().max()) < TOL["q"] and float((ko.qd - po[1].T).abs().max()) < TOL["qd"]
    eager = _gears(8, "cuda", eager=True)
    before = _cuda.FusedStepCall.launches
    state, _ = eager.reset(0)
    for _ in range(3):
        state, *_ = eager.step(state, torch.zeros(8, eager.num_acts, device="cuda"))
    assert _cuda.FusedStepCall.launches == before and bool(torch.isfinite(state.sim.q).all())
