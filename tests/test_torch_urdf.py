"""The port's URDF parser against the JAX package's on the bundled
cartpole.urdf, and the facts tests/test_model.py pins for that asset."""
import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from isaacgymenvs_tpu.model import load_urdf as jax_load_urdf
from isaacgymenvs_tpu_torch.model import FIXED, HINGE, SLIDE, load_urdf, parse_urdf
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root

CARTPOLE = os.path.join(package_asset_root(), "urdf", "cartpole.urdf")


@pytest.mark.parametrize("fix_base", [True, False])
def test_parser_matches_jax_on_cartpole(fix_base):
    """Field by field, atol 1e-6 (both parse in float64 and store float32)."""
    jm, tm = jax_load_urdf(CARTPOLE, fix_base=fix_base), load_urdf(CARTPOLE, fix_base=fix_base)
    for f in dataclasses.fields(tm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif isinstance(b, np.ndarray):
            a = np.asarray(a)
            assert a.shape == b.shape, f.name
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), atol=1e-6, err_msg=f.name)
        else:
            assert tuple(a) == tuple(b) if isinstance(b, tuple) else a == b, f.name


def test_bundled_cartpole_facts():
    m = load_urdf(CARTPOLE, fix_base=True)
    assert m.nbody == 3 and m.nq == 2 and m.nv == 2
    assert m.jnt_type == (FIXED, SLIDE, HINGE)
    assert m.body_names == ("slider", "cart", "pole")
    np.testing.assert_allclose(m.jnt_axis[1], [0, 1, 0], atol=1e-6)  # cart slides along y
    np.testing.assert_allclose(m.jnt_axis[2], [1, 0, 0], atol=1e-6)  # pole hinge about x
    np.testing.assert_allclose(m.body_pos[2], [0.12, 0, 0], atol=1e-6)
    np.testing.assert_allclose(m.body_mass[1:], [1.0, 1.0], atol=1e-6)
    assert m.body_mass[0] > 0  # the rail's mass comes from its box at the default density
    np.testing.assert_allclose(m.body_ipos[2], [0, 0, 0.47], atol=1e-6)
    # no inertia tensor on the pole: derived from the 0.04 x 0.06 x 1.0 box at mass 1
    assert abs(m.body_inertia[2][0, 0] - (0.06**2 + 1.0**2) / 12.0) < 1e-4
    assert (m.dof_limit_lower[0], m.dof_limit_upper[0]) == (-4.0, 4.0)
    assert m.dof_limited[0] == 1.0 and m.dof_limited[1] == 0.0  # continuous joint unlimited
    assert m.ngeom == 3 and m.ncp == 24  # three boxes, eight corners each


def test_unported_urdf_features_raise():
    """Nothing of the URDF subset raises any more: collapse_fixed is ported
    (a model without fixed joints comes out the same with it), and so is
    mesh geometry, where a mesh file that cannot be found drops its geom,
    as the JAX parser does (the mesh path itself: tests/test_torch_franka.py)."""
    from isaacgymenvs_tpu.model.urdf import parse_urdf as jax_parse_urdf

    root = ET.parse(CARTPOLE).getroot()
    loose = parse_urdf(root)
    collapsed = parse_urdf(root, collapse_fixed=True)
    assert collapsed.body_names == loose.body_names and np.array_equal(collapsed.body_mass, loose.body_mass)
    geo = root.find("link").find("collision").find("geometry")
    geo.remove(geo.find("box"))
    ET.SubElement(geo, "mesh", filename="rail.obj")
    dropped = parse_urdf(root)
    assert dropped.ngeom == loose.ngeom - 1 and dropped.ncp == loose.ncp - 8
    assert dropped.ngeom == jax_parse_urdf(root).ngeom
