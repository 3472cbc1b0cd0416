"""`make()` and a PBT population of the port on the card.

This file imports no JAX, so it runs on the GPU machine:

    python -m pytest tests/test_torch_pbt_card.py -m cuda --noconftest -p no:cacheprovider

The `cuda`-marked tests skip where there is no card.
"""
import pytest
import torch

import isaacgymenvs_tpu_torch as port
from isaacgymenvs_tpu_torch.engine import _cuda


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_make_steps_through_the_kernel_on_card():
    _needs_card()
    env = port.make(task="Ant", num_envs=256)
    assert env.device.type == "cuda" and env.num_envs == 256
    state, obs = env.reset(0)
    before = _cuda.FusedStepCall.launches
    state, obs, rew, done, _ = env.step(state, torch.zeros(256, env.num_acts, device="cuda"))
    torch.cuda.synchronize()
    assert _cuda.FusedStepCall.launches - before == env.control_freq_inv
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(rew).all())
    variant = port.make(task="AntSAC", num_envs=64)
    assert type(variant).__name__ == "Ant" and variant.device.type == "cuda"


@pytest.mark.cuda
def test_pbt_population_on_card():
    """Two Ant members at 1,024 envs launched together: both exit with 0,
    the trailing one adopts the other's weights (restored bit for bit) and
    mutates its params within their bounds (`chip_smoke.pbt_population`
    checks each)."""
    _needs_card()
    import chip_smoke

    out = chip_smoke.pbt_population(num_envs=1024, epochs=60, alone_epochs=0)
    assert any(r["from_other"] and r["mutated"] for r in out["restarts"])
