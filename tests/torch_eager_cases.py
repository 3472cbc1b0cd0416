"""Cases and helpers shared by the eager engine's tests against the JAX
package (tests/test_torch_engine_eager.py: the narrowphase, the dynamics
and the constraint rows; tests/test_torch_engine_eager_steps.py: the
solve, the body wrenches, whole steps and the behaviours of
tests/test_contacts.py).

The port's functions are batched over envs; the JAX functions run under
`jax.vmap` (`jax_vmap`), per-env model leaves and gravity through the vmap
axes, as the JAX `VecTask` runs them. `close` holds a single function at
rtol 1e-5 with an absolute floor of 1e-5 times the reference's largest
magnitude; M^-1 and qdd, the outputs of an inverse, at INV_RTOL 1e-4 (two
libraries' float32 Cholesky factorizations part by about cond(M) eps: 2.6e-5
on BallBalance's light legs). Whole steps: TOL, the tolerances of
tests/test_fused.py:79-82.

Models (`case`): the examples of `model/examples.py` (the tendon chain:
plane rows with restitution, a point-vs-box pair, a tendon, joint friction
and limits; the pair-row example; the same bodies with geom-geom pairs; the
ball on an SDF box), BallBalance (anchors and a point-vs-cylinder pair) and
the Ant on a random heightfield.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isaacgymenvs_tpu.engine import SimParams as JSimParams
from isaacgymenvs_tpu.engine import contacts as jcon
from isaacgymenvs_tpu.engine import dynamics as jdyn
from isaacgymenvs_tpu.engine.step import _masks
from isaacgymenvs_tpu.model import spec as jspec
from isaacgymenvs_tpu_torch.engine.dynamics import SimParams, Terrain
from isaacgymenvs_tpu_torch.model import examples
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root

N = 4
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
INV_RTOL = 1e-4
# every per-env leaf the port's kernel takes, and gravity
ALL_LEAVES = ("dof_damping", "dof_stiffness", "dof_friction", "armature", "dof_limit_lower", "dof_limit_upper",
              "body_mass", "cpoint_friction", "cpoint_restitution", "tendon_stiffness", "tendon_damping",
              "body_ipos", "body_inertia", "cpoint_pos", "geom_size", "gravity")


def close(port, ref, what, rtol=1e-5):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * max(scale, 1e-12), err_msg=what)


def jmodel(m):
    """The JAX Model with the port Model's fields."""
    kw = {}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if isinstance(v, np.ndarray):
            v = jnp.asarray(v)
        elif isinstance(v, tuple) and v and isinstance(v[0], np.ndarray):
            v = tuple(jnp.asarray(x) for x in v)
        kw[f.name] = v
    return jspec.Model(**kw)


def jparams(p: SimParams, gravity=None):
    kw = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    kw["gravity"] = jnp.asarray(p.gravity if gravity is None else gravity, jnp.float32)
    return JSimParams(**kw)


def geom_pair_example():
    """The pair-row example's bodies with geom-geom pairs in place of its
    point pairs: sphere A against the box, sphere B against the box and
    against sphere A."""
    m = examples.pair_row_example()
    g = m.ppair_geom
    ga = m.geom_body.index(1)  # ball_a's sphere geom
    gb = m.geom_body.index(2)  # ball_b's
    return m.replace(ppair_point=(), ppair_geom=(), pair_geom_a=(ga, gb, gb), pair_geom_b=(g[0], g[1], g[2]))


def ball_balance_model():
    from isaacgymenvs_tpu_torch.tasks import task_map

    env = task_map["BallBalance"]({"env": {"numEnvs": N}, "sim": {"dt": 1 / 60, "substeps": 2}}, device="cpu")
    q, qd, _ = env.sample_init(torch.Generator().manual_seed(0), N)
    return env.model, env.sim_params, q.numpy(), qd.numpy()


def ant_terrain_model(seed=0):
    from isaacgymenvs_tpu_torch.model import load_mjcf

    m = load_mjcf(os.path.join(package_asset_root(), "mjcf", "nv_ant.xml"))
    rng = np.random.RandomState(seed)
    height = rng.uniform(-0.05, 0.05, (40, 40)).astype(np.float32)
    origin = np.array([-2.0, -2.0], np.float32)
    q = np.tile(np.asarray(m.qpos0, np.float32), (N, 1))
    q[:, :2] = rng.uniform(-0.3, 0.3, (N, 2))
    q[:, 2] = rng.uniform(0.45, 0.55, N)
    qd = rng.uniform(-0.1, 0.1, (N, m.nv)).astype(np.float32)
    return m, SimParams(substeps=2, max_active_contacts=0), q, qd, (height, 0.1, origin)


# a contact margin of 2 cm: the box's corners, which touch the ground, lie in it
MARGIN = SimParams(substeps=2, contact_margin=0.02)


def case(name):
    """(port Model, SimParams, q, qd, terrain (height, scale, origin) or None)."""
    if name == "tendon":
        m = examples.tendon_chain_example()
        return (m, MARGIN, *examples.tendon_chain_example_state(m, N, 0), None)
    if name == "pair":
        m = examples.pair_row_example()
        return (m, MARGIN, *examples.pair_row_example_state(m, N, 1), None)
    if name == "geom_pair":
        m = geom_pair_example()
        return (m, MARGIN, *examples.pair_row_example_state(m, N, 2), None)
    if name == "sdf":
        m = examples.ball_on_sdf_box()
        q = np.tile(np.asarray(m.qpos0, np.float32), (N, 1))
        rng = np.random.RandomState(3)
        q[:, :2] = rng.uniform(-0.1, 0.1, (N, 2))
        q[:, 2] = 0.45 - rng.uniform(0.0, 2e-3, N)  # the ball 0-2 mm into the box's top
        return m, MARGIN, q, rng.uniform(-0.05, 0.05, (N, m.nv)).astype(np.float32), None
    if name == "anchors":
        return (*ball_balance_model(), None)
    if name == "terrain":
        return ant_terrain_model()
    raise KeyError(name)


CASES = ("tendon", "pair", "geom_pair", "sdf", "anchors", "terrain")


def terrains(terr):
    if terr is None:
        return None, None
    h, s, o = terr
    return (Terrain(torch.tensor(h), s, torch.tensor(o)),
            jdyn.Terrain(height=jnp.asarray(h), horizontal_scale=s, origin=jnp.asarray(o)))


def leaves_of(m, names, seed):
    """Per-env leaves drawn as `examples.random_leaves` draws them: numpy
    (JAX side) and tensors (port side)."""
    lv = examples.random_leaves(m, [k for k in names if k == "gravity" or getattr(m, k) is not None], N, seed)
    return lv, {k: torch.tensor(v) for k, v in lv.items()}


def jax_vmap(fn, jm, jp, leaves=None):
    """vmap of fn(model, params, *per-env args) over envs, the model's and
    params' per-env leaves among the vmapped axes."""
    m_axes = jax.tree.map(lambda _: None, jm)
    p_axes = jax.tree.map(lambda _: None, jp)
    if leaves:
        jm = jm.replace(**{k: jnp.asarray(v) for k, v in leaves.items() if k != "gravity"})
        m_axes = m_axes.replace(**{k: 0 for k in leaves if k != "gravity"})
        if "gravity" in leaves:
            jp = jp.replace(gravity=jnp.asarray(leaves["gravity"]))
            p_axes = p_axes.replace(gravity=0)
    return lambda *args: jax.vmap(fn, in_axes=(m_axes, p_axes) + (0,) * len(args))(jm, jp, *args)



def jax_rows(jm, jp, q, qd, terr, lv=None):
    """JAX's constraint rows, M^-1 and free velocity at (q, qd), vmapped."""
    h = jp.dt / (jp.substeps * jp.solver_iterations)

    def fn(m, p, q_, qd_):
        masks, sq, meta = _masks(m)
        kin = jdyn.forward_kinematics(m, q_, qd_, meta)
        qdd, minv_mul, _ = jdyn.forward_dynamics(m, q_, qd_, jnp.zeros(m.nv), jnp.zeros((m.nbody, 6)), p, masks, sq,
                                                 kin=kin, h=h)
        con = jcon.constraint_data(m, kin, masks[0], terrain=terr)
        return kin, con, minv_mul(jnp.eye(m.nv)), qd_ + h * qdd

    return jax_vmap(fn, jm, jp, lv)(jnp.asarray(q), jnp.asarray(qd))
