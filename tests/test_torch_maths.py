"""Port maths helpers against isaacgymenvs_tpu.maths on the same inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_tpu import maths as jm
from isaacgymenvs_tpu_torch import maths as tm
from isaacgymenvs_tpu_torch.engine import fused as tfused
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    # rotation vectors over the Taylor branch (|phi|^2 < 1e-12) and beyond
    phi = np.concatenate([v[:32] * 1e-7, v[32:]]).astype(np.float32)
    x = rng.uniform(-10, 10, size=(64,)).astype(np.float32)
    return q, v, phi, x


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", ["quat_rotate", "quat_rotate_inverse"])
def test_quat_rotations(data, fn):
    q, v, _, _ = data
    close(getattr(jm, fn)(jnp.asarray(q), jnp.asarray(v)), getattr(tm, fn)(torch.tensor(q), torch.tensor(v)))


def test_quat_rotate_broadcasts_a_constant_vector(data):
    q = data[0]
    up = np.array([0.0, 0.0, 1.0], np.float32)
    close(jm.quat_rotate(jnp.asarray(q), jnp.asarray(up)), tm.quat_rotate(torch.tensor(q), torch.tensor(up)))


def test_get_euler_xyz(data):
    q = data[0]
    for a, b in zip(jm.get_euler_xyz(jnp.asarray(q)), tm.get_euler_xyz(torch.tensor(q))):
        close(a, b, 1e-4)


@pytest.mark.parametrize("fn", ["normalize_angle"])
def test_angle_helpers(data, fn):
    x = data[3]
    close(getattr(jm, fn)(jnp.asarray(x)), getattr(tm, fn)(torch.tensor(x)))


def test_normalize_and_unscale(data):
    _, v, _, x = data
    close(jm.normalize(jnp.asarray(v)), tm.normalize(torch.tensor(v)))
    lo, hi = np.float32(-2.0), np.float32(3.0)
    close(jm.unscale(jnp.asarray(x), lo, hi), tm.unscale(torch.tensor(x), lo, hi))


def test_quat_exp_and_fused_helpers(data):
    q, _, phi, _ = data
    close(jm.quat_exp(jnp.asarray(phi)), tm.quat_exp(torch.tensor(phi)), 1e-6)
    # the component-list helpers of the fused step (fused.py _qexp, _qnormalize)
    comps = tfused._qexp([torch.tensor(phi[:, k]) for k in range(3)])
    close(jm.quat_exp(jnp.asarray(phi)), torch.stack(comps, -1), 1e-6)
    raw = q * 1.7
    qn = tfused._qnormalize([torch.tensor(raw[:, k]) for k in range(4)])
    close(jm.quat_unit(jnp.asarray(raw)), torch.stack(qn, -1))
    v = np.ones((64, 3), np.float32)
    rot = tfused._qrot([torch.tensor(q[:, k]) for k in range(4)], [torch.tensor(v[:, k]) for k in range(3)])
    close(jm.quat_rotate(jnp.asarray(q), jnp.asarray(v)), torch.stack(rot, -1))
