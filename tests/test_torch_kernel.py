"""The hand-written fused-step kernel against its plain PyTorch version.

This file imports no JAX, so it also runs on the GPU machine:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -p no:cacheprovider

The `cuda`-marked tests skip where there is no card.
"""
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
    _needs_card()
    env = _ant(4, "cuda")
    state, _ = env.reset(0)
    pair = env.model.replace(ppair_point=(0,), ppair_geom=(0,))
    with pytest.raises(NotImplementedError):
        fused.physics_step_fused(pair, env.sim_params, state.sim.q, state.sim.qd,
                                 torch.zeros(4, env.model.nv, device="cuda"))
