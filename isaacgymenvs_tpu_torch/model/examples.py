"""A small procedural model that runs the pair-row branches no task of the
port reaches yet: a point against a BOX geom and against a SPHERE geom.

A free box lies on the ground; a free sphere A rests on its top face and a
smaller free sphere B rests on the box beside A, touching it. Three pair
rows: A's centre point against the box, B's centre point against the box,
and B's centre point against A's sphere geom. With the box's eight corner
points and the two sphere points as plane candidates the solve has 13
contacts (39 rows) over nv = 18.
"""
from __future__ import annotations

import numpy as np

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
