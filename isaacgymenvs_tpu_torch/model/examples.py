"""Small procedural models that run what no task of the port reaches yet.

`pair_row_example`: the pair-row branches of a point against a BOX geom and
against a SPHERE geom. `tendon_chain_example`: a fixed tendon, restitution
on plane rows and a pair row whose point, geom size and friction all matter,
so that every per-env leaf of the fused step has something to act on.

A free box lies on the ground; a free sphere A rests on its top face and a
smaller free sphere B rests on the box beside A, touching it. Three pair
rows: A's centre point against the box, B's centre point against the box,
and B's centre point against A's sphere geom. With the box's eight corner
points and the two sphere points as plane candidates the solve has 13
contacts (39 rows) over nv = 18.

`ball_on_sdf_box`: the smallest model with an SDF pair row and no top-K cap
(the JAX package's tests/test_sdf.py test_ball_rests_on_sdf_box): a free
ball of radius 0.05 m dropped from 0.5 m onto a fixed box whose voxel SDF
grid (a 0.4 m cube mesh, resolution 48) is paired with the ball's centre
point; it rests at z = 0.45 m.
"""
from __future__ import annotations

import numpy as np

from . import spec as _spec
from .spec import FREE, GEOM_BOX, GEOM_SPHERE, Model, ModelBuilder, box_inertia, sphere_inertia

BOX_HALF = (0.3, 0.3, 0.1)
RADIUS_A, RADIUS_B = 0.1, 0.08


def pair_row_example() -> Model:
    b = ModelBuilder()
    quat = np.array([0, 0, 0, 1], np.float32)

    def free_body(name, mass, inertia, pos):
        i = b.add_body(parent=-1, name=name, pos=(0, 0, 0), quat=(0, 0, 0, 1),
                       jnt_type=FREE, mass=mass, inertia=inertia)
        b.qpos0_free[i] = (np.asarray(pos, np.float32), quat)
        return i

    top = 2 * BOX_HALF[2]
    box = free_body("box", *box_inertia(400.0, BOX_HALF), (0, 0, BOX_HALF[2]))
    b.add_geom(box, GEOM_BOX, (0, 0, 0), (0, 0, 0, 1), BOX_HALF, 1.0)
    ball_a = free_body("ball_a", *sphere_inertia(300.0, RADIUS_A), (0, 0, top + RADIUS_A))
    b.add_geom(ball_a, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (RADIUS_A, 0, 0), 0.8)
    # B touches A: centre distance = the two radii, both resting on the box
    dx = float(np.sqrt((RADIUS_A + RADIUS_B) ** 2 - (RADIUS_A - RADIUS_B) ** 2))
    ball_b = free_body("ball_b", *sphere_inertia(300.0, RADIUS_B), (dx, 0, top + RADIUS_B))
    b.add_geom(ball_b, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (RADIUS_B, 0, 0), 0.6)
    m = b.finalize()
    cp_a, cp_b = m.cpoint_body.index(ball_a), m.cpoint_body.index(ball_b)
    g_box, g_a = m.geom_body.index(box), m.geom_body.index(ball_a)
    return m.replace(ppair_point=(cp_a, cp_b, cp_b), ppair_geom=(g_box, g_box, g_a))


def pair_row_example_state(model: Model, n: int, seed: int, depth: float = 0.002):
    """(q, qd) numpy arrays of `n` envs with all three pair rows active: the
    spheres sit `depth` inside the box's top face and each other, shifted
    together by a random offset on the face."""
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(model.qpos0, np.float32), (n, 1))
    shift = rng.uniform(-0.08, 0.08, (n, 2)).astype(np.float32)
    for body, squeeze in ((1, 0.0), (2, depth)):
        qa = model.q_adr[body]
        q[:, qa:qa + 2] += shift
        q[:, qa] -= squeeze  # B moves into A
        q[:, qa + 2] -= depth
    qd = rng.uniform(-0.05, 0.05, (n, model.nv)).astype(np.float32)
    return q, qd


# ---- a two-hinge arm with a tendon, pressing its tip on a box ---------------

ARM_LINK = 0.2  # length of each link
ARM_BASE = (-0.25, 0.0, 0.45)  # the shoulder hinge, fixed in the world
TIP_RADIUS = 0.05
ARM_REST = (np.pi / 6, 0.0)  # shoulder, elbow: the tip then touches the box's top face


def tendon_chain_example(spec=_spec) -> Model:
    """A free box on the ground (its eight corners are plane candidates with
    restitution 0.5) and a two-link arm hinged to the world about y, whose
    tip sphere presses on the box's top face at `ARM_REST`: one pair row,
    the tip's candidate point (offset `ARM_LINK` along its link) against the
    box geom. The hinges have stiffness, damping, armature, joint friction
    and limits; a fixed tendon couples them (length = shoulder + 0.5 elbow,
    range +-0.3, so at rest it is stretched past its range) with stiffness 5
    and damping 0.5. nbody 3, nq 9, nv 8, 10 plane candidates + 1 pair row.

    `spec` is the module that gives `ModelBuilder`, the joint and geom type
    constants and `box_inertia`: this package's, or (in a test) the module of
    the same name of another package with the same `ModelBuilder`, whose
    Model then comes out of the same calls.
    """
    b = spec.ModelBuilder()
    mass, inertia = spec.box_inertia(400.0, BOX_HALF)
    box = b.add_body(parent=-1, name="box", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=spec.FREE,
                     mass=mass, inertia=inertia)
    b.qpos0_free[box] = (np.array([0, 0, BOX_HALF[2]], np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(box, spec.GEOM_BOX, (0, 0, 0), (0, 0, 0, 1), BOX_HALF, 1.0)
    hinge = dict(jnt_type=spec.HINGE, jnt_axis=(0, 1, 0), quat=(0, 0, 0, 1), ipos=(ARM_LINK / 2, 0, 0),
                 inertia=np.diag([2e-4, 4e-3, 4e-3]).astype(np.float32), armature=0.01, damping=0.5,
                 stiffness=2.0, friction_loss=0.05, limit=(-1.5, 1.5))
    upper = b.add_body(parent=-1, name="upper", pos=ARM_BASE, joint_name="shoulder", mass=1.0, **hinge)
    b.add_geom(upper, spec.GEOM_SPHERE, (ARM_LINK, 0, 0), (0, 0, 0, 1), (0.04, 0, 0), 0.7)
    lower = b.add_body(parent=upper, name="lower", pos=(ARM_LINK, 0, 0), joint_name="elbow", mass=0.8, **hinge)
    b.add_geom(lower, spec.GEOM_SPHERE, (ARM_LINK, 0, 0), (0, 0, 0, 1), (TIP_RADIUS, 0, 0), 0.6)
    b.qpos0_scalar[upper], b.qpos0_scalar[lower] = ARM_REST
    b.add_tendon("coupler", [("shoulder", 1.0), ("elbow", 0.5)], (-0.3, 0.3))
    m = b.finalize()
    bodies = np.asarray(m.cpoint_body)
    tip = int(np.flatnonzero(bodies == lower).max())
    rest = np.where(bodies == box, 0.5, 0.0).astype(np.float32)
    return m.replace(
        ppair_point=(tip,), ppair_geom=(int(np.flatnonzero(np.asarray(m.geom_body) == box)[0]),),
        cpoint_restitution=rest,
        tendon_stiffness=np.array([5.0], np.float32), tendon_damping=np.array([0.5], np.float32),
    )


def tendon_chain_example_state(model: Model, n: int, seed: int, depth: float = 0.002):
    """(q, qd) numpy arrays of `n` envs: the box shifted on the ground, the
    arm straight with its tip `depth` inside the box's top face."""
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(model.qpos0, np.float32), (n, 1))
    q[:, :2] += rng.uniform(-0.05, 0.05, (n, 2)).astype(np.float32)
    drop = ARM_BASE[2] - (2 * BOX_HALF[2] + TIP_RADIUS - depth)  # shoulder above the tip's centre
    q[:, model.q_adr[1]] = np.arcsin(drop / (2 * ARM_LINK))
    qd = rng.uniform(-0.05, 0.05, (n, model.nv)).astype(np.float32)
    return q, qd


# ---- per-env leaves for comparisons ------------------------------------------

# leaves whose entries are lengths or places: scaled a little, so that what
# touches keeps touching
_GEOMETRY_LEAVES = ("body_ipos", "cpoint_pos", "geom_size")


def random_leaves(model: Model, names, n: int, seed: int, gravity=(0.0, 0.0, -9.81)) -> dict:
    """Per-env model leaves {name: (n, *leaf.shape) float32 array} for the
    fused step's `dyn` input, drawn with numpy from `seed` the way a
    domain-randomization yaml would: factors in [0.5, 1.5] on masses,
    inertias, gains and frictions (the ranges of cfg/task/Ant.yaml),
    gaussian offsets of 0.01 on the limits, factors in [0.97, 1.03] on the
    geometry leaves, restitution in [0.2, 0.8], joint friction in [0, 0.05],
    and for "gravity" the base vector scaled by [0.9, 1.1] plus [-0.3, 0.3]."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    out = {}
    for k in names:
        if k == "gravity":
            out[k] = f32(gravity)[None] * rng.uniform(0.9, 1.1, (n, 3)) + rng.uniform(-0.3, 0.3, (n, 3))
        elif k == "cpoint_restitution":
            out[k] = rng.uniform(0.2, 0.8, (n, model.ncp))
        elif k == "dof_friction":
            out[k] = rng.uniform(0.0, 0.05, (n, model.nv))
        elif k in ("dof_limit_lower", "dof_limit_upper"):
            out[k] = f32(getattr(model, k))[None] + rng.normal(0.0, 0.01, (n, model.nv))
        else:
            base = f32(getattr(model, k))
            lo, hi = (0.97, 1.03) if k in _GEOMETRY_LEAVES else (0.5, 1.5)
            out[k] = base[None] * rng.uniform(lo, hi, (n,) + base.shape)
    return {k: f32(v) for k, v in out.items()}


def cube_mesh(half: float = 0.2):
    """A closed cube mesh of half-width `half`, wound outward: (verts, tris)."""
    verts = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64) * half
    tris = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                     [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)
    return verts, tris


def ball_on_sdf_box() -> Model:
    """See the module docstring; builds the box's grid with the voxelizer."""
    from ..sdf.builder import attach_sdf, mesh_to_sdf, pair_points_with_sdf

    b = ModelBuilder()
    mass, inertia = sphere_inertia(1000.0, 0.05)
    ball = b.add_body(parent=-1, name="ball", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FREE, mass=mass,
                      inertia=inertia)
    b.qpos0_free[ball] = (np.array([0.03, 0.0, 0.5], np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(ball, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (0.05, 0, 0), 0.8)
    box = b.add_body(parent=-1, name="box", pos=(0, 0, 0.2), quat=(0, 0, 0, 1), jnt_type=_spec.FIXED)
    model = b.finalize()
    model, g = attach_sdf(model, box, mesh_to_sdf(*cube_mesh(0.2), resolution=48))
    return pair_points_with_sdf(model, [0], g)  # the ball's centre point
