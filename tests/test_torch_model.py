"""Port model layer: the MJCF parser and Model against the JAX package.

Both packages read the hand-written Ant bundled with the port
(isaacgymenvs_tpu_torch/assets/mjcf/nv_ant.xml).
"""
import dataclasses
import os

import numpy as np
import pytest

from isaacgymenvs_tpu.model import load_mjcf as jax_load_mjcf
from isaacgymenvs_tpu.model import spec as jspec
from isaacgymenvs_tpu_torch.convert import model_from_arrays
from isaacgymenvs_tpu_torch.model import FREE, GEOM_CAPSULE, GEOM_SPHERE, HINGE
from isaacgymenvs_tpu_torch.model import spec as tspec
from isaacgymenvs_tpu_torch.model import load_mjcf
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root

ANT = os.path.join(package_asset_root(), "mjcf", "nv_ant.xml")


def _fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


def _assert_models_equal(a: dict, b: dict, atol=1e-6):
    assert set(a) == set(b)
    for k in a:
        va, vb = a[k], b[k]
        if va is None or vb is None:
            assert va is None and vb is None, k
        elif isinstance(va, tuple) and (not va or not hasattr(va[0], "shape")):
            assert tuple(va) == tuple(vb), k
        else:
            na, nb = np.asarray(va), np.asarray(vb)
            assert na.shape == nb.shape, k
            np.testing.assert_allclose(na.astype(np.float64), nb.astype(np.float64),
                                       atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def models():
    return jax_load_mjcf(ANT), load_mjcf(ANT)


def test_parser_matches_jax_on_ant(models):
    jm, tm = models
    ja = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in _fields(jm).items()}
    _assert_models_equal(ja, _fields(tm))


def test_bundled_ant_structure(models):
    _, m = models
    assert m.nbody == 9 and m.nq == 15 and m.nv == 14 and m.nu == 8
    assert m.jnt_type[0] == FREE and all(t == HINGE for t in m.jnt_type[1:])
    np.testing.assert_allclose(m.gear, 15.0)
    hip1 = m.dof_joint_names().index("hip_1")
    np.testing.assert_allclose(m.dof_limit_lower[hip1], -40 * np.pi / 180, atol=1e-5)
    np.testing.assert_allclose(m.dof_limit_upper[hip1], 40 * np.pi / 180, atol=1e-5)
    assert abs(m.armature[6] - 0.01) < 1e-6 and abs(m.dof_damping[6] - 0.1) < 1e-6
    assert m.ngeom == 13 and m.ncp == 25
    assert m.geom_type[0] == GEOM_SPHERE and abs(m.geom_size[0][0] - 0.25) < 1e-6
    assert m.body_mass[0] > 5.0 * 4 / 3 * np.pi * 0.25**3  # torso sphere + capsule halves
    np.testing.assert_allclose(m.qpos0[:3], [0, 0, 0.55], atol=1e-6)
    np.testing.assert_allclose(m.qpos0[3:7], [0, 0, 0, 1], atol=1e-6)
    feet = [i for i, n in enumerate(m.body_names) if "foot" in n]
    assert len(feet) == 4
    fl = m.body_names.index("front_left_foot")
    (g,) = [g for g in range(m.ngeom) if m.geom_body[g] == fl]
    assert m.geom_type[g] == GEOM_CAPSULE
    ends = sorted(tuple(np.round(m.cpoint_pos[i], 5)) for i in range(m.ncp) if m.cpoint_body[i] == fl)
    np.testing.assert_allclose(ends, [(0.0, 0.0, 0.0), (0.4, 0.4, 0.0)], atol=1e-5)


def _build(mod):
    """The same small fixture through either package's ModelBuilder."""
    b = mod.ModelBuilder()
    base = b.add_body(parent=-1, name="base", pos=(0, 0, 0), quat=(0, 0, 0, 1),
                      jnt_type=mod.FREE, mass=2.0, inertia=np.eye(3) * 0.02)
    b.qpos0_free[base] = (np.array([0, 0, 0.5], np.float32), np.array([0, 0, 0, 1], np.float32))
    arm = b.add_body(parent=base, name="arm", pos=(0.1, 0, 0), quat=(0, 0, 0, 1),
                     jnt_type=mod.HINGE, jnt_axis=(0, 1, 0), joint_name="j0", mass=0.5,
                     ipos=(0.1, 0, 0), inertia=np.eye(3) * 1e-3, armature=0.01,
                     damping=0.2, limit=(-1.0, 1.0))
    b.add_body(parent=arm, name="tip", pos=(0.2, 0, 0), quat=(0, 0, 0, 1),
               jnt_type=mod.SLIDE, jnt_axis=(1, 0, 0), joint_name="j1", mass=0.1,
               inertia=np.eye(3) * 1e-4, stiffness=5.0)
    b.add_geom(base, mod.GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (0.1, 0, 0), 1.0)
    b.add_geom(arm, mod.GEOM_CAPSULE, (0.1, 0, 0), (0, 0.7071068, 0, 0.7071068), (0.03, 0.1, 0), 0.8)
    b.add_actuator("j0", 10.0, (-1.0, 1.0))
    return b.finalize()


def test_model_from_arrays_roundtrip():
    jm = _build(jspec)
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in _fields(jm).items()}
    converted = model_from_arrays(fields)
    _assert_models_equal(_fields(converted), _fields(_build(tspec)))
    assert isinstance(converted.body_mass, np.ndarray) and converted.body_mass.dtype == np.float32
    with pytest.raises(KeyError):
        model_from_arrays({**fields, "not_a_field": 1})


def test_model_tensor_view(models):
    _, m = models
    t = m.to("cpu")
    assert tuple(t.body_inertia.shape) == (9, 3, 3)
    np.testing.assert_allclose(t.qpos0.numpy(), m.qpos0)
