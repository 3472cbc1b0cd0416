"""FactoryTaskInsertion and FactoryTaskGears: the environment-only
templates (port of isaacgymenvs_tpu/tasks/factory_templates.py), batched
over envs.

The reference ships only the environment (factory_task_insertion.py):
observations stay zero, the reward is zero, actions are stored and never
applied, and a reset puts the Franka at mid-range joints (plus
`joint_noise`) and drops the plug at a biased random pose on the table
(`initial_state: goal` puts it in the socket). The Franka holds its pose
through the joint PD drive (stiffness 40 / damping 8, fingers 500 / 20) with
its reset pose as the `q_target` setpoint, under gravity compensation: each
Franka body takes its weight back as an external wrench at its centre of
mass (`xfrc`), from the port's batched FK. The plug is a free body whose
contact set is 64 points sampled from its mesh, against the table plane and
against the voxel SDF grid of the socket mesh on the fixed socket body; the
Franka has no contact points. The cfg caps the active set at 32 contacts.

FactoryTaskGears drops three free gears (small, medium, large) on the
table beside a fixed gear base (`initial_state: goal` puts them on their
shafts); each gear's contact set is 40 points sampled from its mesh, against
the table plane and against the voxel SDF grid (192 voxels along the base's
longest side) of the base mesh: 120 plane and 120 SDF rows under the cfg's
cap of 96, nv 27. Gear against gear is not modelled (the JAX package's
documented divergence). The kernel covers it (`physics_route` "kernel"); the
JAX package, whose TPU kernel cannot hold it, steps it on its eager engine,
the port's route under `sim.use_fused: False`.

The bundled meshes and Franka are stand-ins (assets/urdf/franka_description,
assets/factory/mesh/factory_insertion and factory_gears, see
assets/factory/make_insertion_meshes.py and make_gears_meshes.py).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..engine import dynamics as _dyn
from ..envcore.vec_task import VecTask
from ..maths import quat_rotate
from ..model import load_urdf
from ..model.compose import compose
from ..model.spec import FIXED, FREE, GEOM_CYLINDER, ModelBuilder
from ..sdf.builder import add_contact_points, attach_sdf, load_obj, mesh_to_sdf, pair_points_with_sdf
from ..utils.assets import asset_path
from .factory_common import _stratified_pick, _strip_points

_INS = "factory/mesh/factory_insertion"
_GEARS = "factory/mesh/factory_gears"

# factory_asset_info_insertion.yaml round_peg_hole_16mm_tight
PEG_DIAMETER = 0.015994
PEG_LENGTH = 0.050
HOLE_HEIGHT = 0.0089916
DENSITY = 8000.0


@lru_cache(maxsize=None)
def _peg_mesh():
    return load_obj(asset_path(f"{_INS}/factory_round_peg_16mm_tight.obj"))


@lru_cache(maxsize=None)
def hole_sdf_grid(resolution: int = 128):
    v, t = load_obj(asset_path(f"{_INS}/factory_round_hole_16mm_subdiv_3x.obj"))
    return mesh_to_sdf(v, t, resolution=resolution, padding=0.1)


@lru_cache(maxsize=None)
def gear_base_sdf_grid(resolution: int = 192):
    v, t = load_obj(asset_path(f"{_GEARS}/factory_gear_base_tight_space_5e-4_subdiv_4x.obj"))
    return mesh_to_sdf(v, t, resolution=resolution, padding=0.05)


def _free_mesh_body(name, mass, ipos, inertia, start_pos):
    b = ModelBuilder()
    body = b.add_body(parent=-1, name=name, pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FREE, mass=mass,
                      ipos=ipos, inertia=inertia)
    b.qpos0_free[body] = (np.asarray(start_pos, np.float32), np.array([0, 0, 0, 1], np.float32))
    # inert proxy geom (mass metadata only; the contacts are the sampled points)
    b.add_geom(body, GEOM_CYLINDER, tuple(ipos), (0, 0, 0, 1), (0.01, 0.01, 0.0), friction=0.5)
    return b.finalize()


def build_peg():
    r, h = PEG_DIAMETER / 2, PEG_LENGTH
    m = np.pi * r * r * h * DENSITY
    izz = 0.5 * m * r * r
    ixx = m / 12.0 * (3 * r * r + h * h)
    return _free_mesh_body("plug", m, (0, 0, h / 2), np.diag([ixx, ixx, izz]), (0.0, -0.1, 0.0))


def _fixed_body(name):
    b = ModelBuilder()
    b.add_body(parent=-1, name=name, pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FIXED, mass=1.0,
               ipos=(0, 0, 0.005), inertia=np.eye(3) * 1e-4)
    return b.finalize()


def _quat_mul_np(a, b):
    """Hamilton product of xyzw quaternions (numpy)."""
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


@lru_cache(maxsize=None)
def peg_contact_points():
    v, _ = _peg_mesh()
    return _stratified_pick(v.astype(np.float32), n_z=8, n_ang=8)


@lru_cache(maxsize=None)
def gear_template_points(size):
    """The 40 contact points of a gear: its mesh's vertices picked 4 x 10
    over (z, the angle about the gear's own centroid); the assembly-frame
    meshes sit off the origin (the small gear about x = 0.05). The large
    gear's mesh is IndustReal's, in the same assembled frame (the
    reference's asset tree has no factory_gear_large_space_5e-4.obj)."""
    if size == "large":
        v, _ = load_obj(asset_path("industreal/mesh/industreal_gears/industreal_gear_large.obj"))
    else:
        v, _ = load_obj(asset_path(f"{_GEARS}/factory_gear_{size}_space_5e-4.obj"))
    v = v.astype(np.float32)
    c = v.mean(0)
    shifted = v - np.array([c[0], c[1], 0.0], np.float32)
    return _stratified_pick(shifted, n_z=4, n_ang=10) + np.array([c[0], c[1], 0.0], np.float32)


class _FactoryTemplate(VecTask):
    """Shared env-only template machinery (see the module docstring)."""

    use_pd_targets = True
    uses_kin = False

    def __init__(self, cfg, device="cuda"):
        env = cfg.setdefault("env", {})
        rl = cfg.get("rl", {})
        r = cfg.get("randomize", {})
        self.num_obs = int(env.get("numObservations", 32))
        self.num_acts = int(env.get("numActions", 12))
        self.num_states = 0
        env.setdefault("episodeLength", int(rl.get("max_episode_length", 1024)))
        self.joint_noise = float(r.get("joint_noise", 0.0))
        self.initial_state = str(r.get("initial_state", "random"))
        self.rand = r
        super().__init__(cfg, device)
        m, dev = self.model, self.device
        fr = [d for d in self.scalar_dof_indices if m.dof_body[d] < self._first_object_body]
        self.q_idx = torch.as_tensor(np.asarray([m.q_adr[m.dof_body[d]] for d in fr], np.int64), device=dev)
        lo = np.asarray(m.dof_limit_lower)[np.asarray(fr)]
        hi = np.asarray(m.dof_limit_upper)[np.asarray(fr)]
        self.q_mid = torch.as_tensor((lo + hi) * 0.5, dtype=torch.float32, device=dev)
        # gravity compensation of the Franka (factory_base.py disable_gravity on the robot)
        self.franka_mass = torch.as_tensor(
            np.where(np.arange(m.nbody) < self._first_object_body, np.asarray(m.body_mass), 0.0),
            dtype=torch.float32, device=dev)
        self._ipos = torch.as_tensor(np.asarray(m.body_ipos, np.float32), device=dev)
        self._gravity = torch.as_tensor(self.sim_params.gravity, dtype=torch.float32, device=dev)
        self._qpos0 = torch.as_tensor(np.asarray(m.qpos0, np.float32), device=dev)

    def _franka(self):
        franka = load_urdf(asset_path("urdf/franka_description/robots/franka_panda.urdf"), fix_base=True)
        # base at (0.5, 0, floor) facing the table centre, yaw pi
        bp = np.asarray(franka.body_pos).copy()
        bq = np.asarray(franka.body_quat).copy()
        bp[0] = [0.5, 0.0, -0.4]
        bq[0] = [0.0, 0.0, 1.0, 0.0]
        nv = franka.nv
        # the gym_default joint PD holds the reset pose (the template applies
        # no task-space control: the reference's pre_physics_step only stores actions)
        stiff = np.full(nv, 40.0, np.float32)
        damp = np.full(nv, 8.0, np.float32)
        stiff[nv - 2:] = 500.0
        damp[nv - 2:] = 20.0
        return franka.replace(body_pos=bp, body_quat=bq, dof_stiffness=stiff, dof_damping=damp)

    # ---- zero control, zero observation, zero reward ---------------------
    def compute_force(self, actions, q, qd, task):
        n = q.shape[0]
        q_target = q.new_zeros(n, self.model.nq)
        q_target[:, self.q_idx] = task["q_ref"]
        kin = _dyn.forward_kinematics(self.model, q, qd)
        com = kin.x + quat_rotate(kin.quat, self._ipos.expand(n, -1, -1))
        f = (-self.franka_mass[:, None] * self._gravity[None, :]).expand(n, -1, -1)
        xfrc = torch.cat([torch.linalg.cross(com, f, dim=-1), f], dim=-1)
        return q.new_zeros(n, self.model.nv), xfrc, q_target

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        return q.new_zeros(q.shape[0], self.num_obs)

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        done = progress >= self.max_episode_length - 1
        return q.new_zeros(q.shape[0]), done, task

    def _franka_reset_q(self, generator, n):
        u = torch.rand(n, self.q_mid.shape[0], generator=generator, device=self.device)
        return self.q_mid + (u * 2.0 - 1.0) * (self.joint_noise * np.pi / 180.0)


class FactoryTaskInsertion(_FactoryTemplate):
    """Peg and hole template (reference factory_task_insertion.py)."""

    def build_model(self):
        model, refs = compose([self._franka(), build_peg(), _fixed_body("socket")], ["", "plug:", "socket:"])
        self.franka_ref, self.plug_ref, self.socket_ref = refs
        self._first_object_body = self.plug_ref.body0
        model = _strip_points(model, set(range(model.nbody)))
        model, cp = add_contact_points(model, self.plug_ref.body0, peg_contact_points(), friction=0.5)
        model, g = attach_sdf(model, self.socket_ref.body0, hole_sdf_grid())
        model = pair_points_with_sdf(model, cp, g)
        return model, self.sim_params_from_cfg()

    def sample_init(self, generator, n):
        m, dev = self.model, self.device
        q = self._qpos0.repeat(n, 1)
        q_ref = self._franka_reset_q(generator, n)
        q[:, self.q_idx] = q_ref
        pq = m.q_adr[self.plug_ref.body0]
        noise = float(self.rand.get("plug_noise_xy", 0.05))
        bias_y = float(self.rand.get("plug_bias_y", -0.1))
        bias_z = float(self.rand.get("plug_bias_z", 0.0))
        xy = (torch.rand(n, 2, generator=generator, device=dev) * 2.0 - 1.0) * noise
        pos = torch.stack([xy[:, 0], bias_y + xy[:, 1], torch.full_like(xy[:, 0], bias_z)], dim=-1)
        if self.initial_state == "goal":
            pos = torch.zeros_like(pos)
        q[:, pq:pq + 3] = pos
        q[:, pq + 3:pq + 7] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        return q, q.new_zeros(n, m.nv), {"q_ref": q_ref}

    def contact_states(self, n: int, seed: int, kinds=("bore", "socket_top", "beside_socket")):
        """n states (q, qd) in which the plug's rows act, for holding the
        kernel against its plain version: the plug upright in the bore
        (within 0.15 mm of the axis, 0-0.5 mm above the table, tilted by up
        to 0.3 degrees), upright on the socket's top face (10-15 mm off the
        axis, 0-0.5 mm above it), or lying on the table against the socket's
        side (0-0.3 mm away; its far end raised by 3-4 degrees and the plug
        rolled by 2-5 degrees about its axis, so that no two of its points
        lie at one height: more than the cap of 32 candidates are active),
        the kinds in turn; gentle velocities, the Franka at mid-range joints.
        Drawn with numpy from `seed`."""
        m, rng = self.model, np.random.RandomState(seed)
        r = PEG_DIAMETER / 2
        q = np.tile(np.asarray(m.qpos0, np.float32), (n, 1))
        q[:, self.q_idx.cpu().numpy()] = self.q_mid.cpu().numpy()
        pq = m.q_adr[self.plug_ref.body0]
        pv = m.v_adr[self.plug_ref.body0]
        qd = np.zeros((n, m.nv), np.float32)
        for i in range(n):
            kind = kinds[i % len(kinds)]
            if kind == "bore":
                pos = [*rng.uniform(-1.5e-4, 1.5e-4, 2), rng.uniform(0.0, 5e-4)]
                axis, ang = rng.normal(size=3), np.deg2rad(rng.uniform(0.0, 0.3))
            elif kind == "socket_top":
                a, d = rng.uniform(0, 2 * np.pi), rng.uniform(0.010, 0.015)
                pos = [d * np.cos(a), d * np.sin(a), HOLE_HEIGHT + rng.uniform(0.0, 5e-4)]
                axis, ang = rng.normal(size=3), np.deg2rad(rng.uniform(0.0, 0.3))
            else:  # lying along -y against the socket's +x face
                pos = [0.020 + r + rng.uniform(0.0, 3e-4), PEG_LENGTH / 2 + rng.uniform(-2e-3, 2e-3),
                       r + rng.uniform(0.0, 3e-4)]
                axis, ang = np.array([1.0, 0.0, 0.0]), np.pi / 2 - np.deg2rad(rng.uniform(3.0, 4.0))
            axis = axis / np.linalg.norm(axis)
            q[i, pq:pq + 3] = pos
            quat = np.array([*(np.sin(ang / 2) * axis), np.cos(ang / 2)])
            if kind == "beside_socket":
                roll = np.deg2rad(rng.uniform(2.0, 5.0)) * rng.choice([-1.0, 1.0])
                quat = _quat_mul_np(quat, np.array([0.0, 0.0, np.sin(roll / 2), np.cos(roll / 2)]))
            q[i, pq + 3:pq + 7] = quat
            qd[i, pv:pv + 6] = rng.uniform(-0.01, 0.01, 6)
        qd[:, self.scalar_dof_indices[self.scalar_dof_indices < pv]] = rng.uniform(-0.01, 0.01, (n, pv))
        dev = self.device
        return torch.tensor(q, device=dev), torch.tensor(qd, device=dev)


# gear -> (its y at a reset as a multiple of gears_bias_y, tip radius, centre-of-mass x); a mis-centred
# centre of mass tips the free disc over on the table
GEAR_SPECS = {"small": (-1.0, 0.011, 0.0508), "medium": (1.0, 0.021, 0.0202), "large": (-1.0, 0.031, -0.0302)}
GEAR_HEIGHT = 0.02  # of the discs whose inertias the gears take
GEAR_BOTTOM_Z = 0.005  # the gear meshes' bottom face in their frame: the base plate's top


class FactoryTaskGears(_FactoryTemplate):
    """Three gears and their base (reference factory_task_gears.py)."""

    def build_model(self):
        gears = []
        for (size, (_, r, cx)), y0 in zip(GEAR_SPECS.items(), (0.1, -0.1, 0.1)):
            m = np.pi * r * r * GEAR_HEIGHT * 1000.0 * 0.7
            izz = 0.5 * m * r * r
            ixx = m / 12.0 * (3 * r * r + GEAR_HEIGHT * GEAR_HEIGHT)
            gears.append(_free_mesh_body(f"gear_{size}", m, (cx, 0, 0.015), np.diag([ixx, ixx, izz]), (0.0, y0, 0.0)))
        model, refs = compose([self._franka()] + gears + [_fixed_body("base")],
                              ["", "gsmall:", "gmed:", "glarge:", "base:"])
        self.franka_ref = refs[0]
        self.gear_refs = refs[1:4]
        self.base_ref = refs[4]
        self._first_object_body = self.gear_refs[0].body0
        model = _strip_points(model, set(range(model.nbody)))
        model, g = attach_sdf(model, self.base_ref.body0, gear_base_sdf_grid())
        for ref, size in zip(self.gear_refs, GEAR_SPECS):
            model, cp = add_contact_points(model, ref.body0, gear_template_points(size), friction=0.5)
            model = pair_points_with_sdf(model, cp, g)
        return model, self.sim_params_from_cfg()

    def sample_init(self, generator, n):
        """The Franka at mid-range joints plus `joint_noise`, the small and
        large gear at y = -gears_bias_y and the medium one at +gears_bias_y
        (plus gears_noise_xy in x and y), upright at gears_bias_z; with
        `initial_state: goal` every gear on its shaft."""
        m, dev = self.model, self.device
        q = self._qpos0.repeat(n, 1)
        q_ref = self._franka_reset_q(generator, n)
        q[:, self.q_idx] = q_ref
        noise = float(self.rand.get("gears_noise_xy", 0.05))
        bias_y = float(self.rand.get("gears_bias_y", -0.1))
        bias_z = float(self.rand.get("gears_bias_z", 0.0))
        for ref, (ysign, _, _) in zip(self.gear_refs, GEAR_SPECS.values()):
            gq = m.q_adr[ref.body0]
            xy = (torch.rand(n, 2, generator=generator, device=dev) * 2.0 - 1.0) * noise
            pos = torch.stack([xy[:, 0], ysign * bias_y + xy[:, 1], torch.full_like(xy[:, 0], bias_z)], dim=-1)
            if self.initial_state == "goal":
                pos = torch.zeros_like(pos)
            q[:, gq:gq + 3] = pos
            q[:, gq + 3:gq + 7] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        return q, q.new_zeros(n, m.nv), {"q_ref": q_ref}

    def contact_states(self, n: int, seed: int, kinds=("table", "shafts")):
        """n states (q, qd) in which the gears' rows act, for holding the
        kernel against its plain version and the eager engine against the
        JAX package: every gear lying on the table at its reset place (0.1-
        0.4 mm into it, tilted by up to 0.3 degrees), or every gear on its
        shaft, on the base's plate (0.1-0.4 mm into it: its bottom points
        then lie in the table's margin too, 4.6-4.9 mm above it), the kinds
        in turn; gentle velocities, the Franka at mid-range joints. Drawn
        with numpy from `seed`."""
        m, rng = self.model, np.random.RandomState(seed)
        q = np.tile(np.asarray(m.qpos0, np.float32), (n, 1))
        q[:, self.q_idx.cpu().numpy()] = self.q_mid.cpu().numpy()
        qd = np.zeros((n, m.nv), np.float32)
        bias_y = float(self.rand.get("gears_bias_y", -0.1))
        for i in range(n):
            on_table = kinds[i % len(kinds)] == "table"
            for ref, (ysign, _, _) in zip(self.gear_refs, GEAR_SPECS.values()):
                gq, gv = m.q_adr[ref.body0], m.v_adr[ref.body0]
                depth = rng.uniform(1e-4, 4e-4)
                if on_table:
                    pos = [rng.uniform(-0.02, 0.02), ysign * bias_y + rng.uniform(-0.02, 0.02), -GEAR_BOTTOM_Z - depth]
                else:
                    pos = [0.0, 0.0, -depth]
                axis = rng.normal(size=3)
                axis, ang = axis / np.linalg.norm(axis), np.deg2rad(rng.uniform(0.0, 0.3))
                q[i, gq:gq + 3] = pos
                q[i, gq + 3:gq + 7] = [*(np.sin(ang / 2) * axis), np.cos(ang / 2)]
                qd[i, gv:gv + 6] = rng.uniform(-0.01, 0.01, 6)
        pv = m.v_adr[self.gear_refs[0].body0]
        qd[:, self.scalar_dof_indices[self.scalar_dof_indices < pv]] = rng.uniform(-0.01, 0.01, (n, pv))
        dev = self.device
        return torch.tensor(q, device=dev), torch.tensor(qd, device=dev)
