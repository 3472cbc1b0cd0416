"""The Factory nut-bolt family: NutBoltPick, NutBoltPlace and NutBoltScrew
(port of isaacgymenvs_tpu/tasks/factory_nut_bolt.py), batched over envs.

A Franka (the Panda stand-in, base at (0.5, 0, -0.4) facing the table,
whose top is z = 0) works an M16 nut against an M16 bolt. The nut is a free
body; the bolt stands at its env's origin on two slide dofs (x, y) of
armature and damping 1e4, which hold it wherever the reset puts it. Every
automatic candidate point is stripped; the contacts are points added from
the meshes: the nut's 12 hex corners (its rims, against the table plane
and the bolt's SDF grid), 48 points of its threaded bore (against the
table and the bolt's grid) and the finger pads' points (against the table
and the nut's grid; a 2 x 3 grid per finger for Screw, 4 x 5 for Place,
6 x 7 for Pick). So the nut's grid rides on a free body and the bolt's on
two slides, and the cfg caps the active set at 16 of up to 288 rows.

The arm is driven through its 7 joint torques by the reference's Factory
controllers, from a task-space increment of the fingertip midpoint (the
actions' first six components, ordered (linear, angular) and scaled by 0.1;
the increment runs (angular, linear) as the JAX package orders it):
`joint_space_id` (Pick, Place) takes damped least-squares IK and a
joint-space PD with the arm's 7 x 7 CRBA mass matrix (gains 40 / 8);
`operational_space_motion` (Screw) keeps the z translation and z rotation
only (gains 1 and 200), and reads the z-rotation action one-sided,
-(a + 1) / 2, so the nut only ever turns clockwise. Torques are clipped to
the effort limits. The fingers' position drives (stiffness 100, damping 2)
take the gripper target as the setpoint; every Franka body takes its weight
back as a wrench at its centre of mass.

Pick: the nut lies on the table (yaw uniform), the fingers open; after
`rl_len` acting steps 25 scripted steps close the gripper and 25 lift it,
with the actions overridden and the reward zeroed; success is the nut above
three nut heights at the last step. Place: the nut starts between the
closed pads (forward kinematics of the reset pose, vectorized over envs);
the reward is the keypoint distance between the nut's axis and the bolt's
above its tip. Screw: the nut starts in mesh at the top of the thread,
30 degrees about z, the fingers squeezing it; the episode ends on success
(the nut's centre of mass within one pitch of the fully screwed height), on
a far, slipped or fallen nut, or at the time limit; `descent` reports how
far the nut ran down the helix.

The meshes are stand-ins written by assets/factory/make_nut_bolt_meshes.py
(the JAX package reads the same files through $ISAACGYMENVS_TPU_ASSETS).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import controllers, maths
from ..engine import dynamics as _dyn
from ..envcore.vec_task import VecTask
from ..model import load_urdf
from ..model.compose import compose
from ..model.spec import FREE, GEOM_CYLINDER, SLIDE, ModelBuilder
from ..sdf.builder import add_contact_points, attach_sdf, load_obj, mesh_to_sdf, pair_points_with_sdf
from ..utils.assets import asset_path
from .factory_common import _stratified_pick, _strip_points
from .franka_cube_stack import _qmul_np, _qrot_np, _quat_np

# assets/factory/yaml/factory_asset_info_nut_bolt.yaml nut_bolt_m16_tight
NUT_WIDTH_MIN = 0.024
NUT_WIDTH_MAX = 0.02771281
NUT_HEIGHT = 0.013
BOLT_WIDTH = 0.016
BOLT_HEAD_HEIGHT = 0.016
BOLT_SHANK_LENGTH = 0.025
THREAD_PITCH = 0.002
BOLT_TOP = BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH

# assets/factory/yaml/factory_asset_info_franka_table.yaml
HAND_LENGTH = 0.0584
FINGER_LENGTH = 0.053671
FINGERPAD_LENGTH = 0.017608

DENSITY = 7850.0  # steel

_MESH = "factory/mesh/factory_nut_bolt"

# the nut's yaw from the hand's that puts its hex flats against the pads
NUT_GRIP_YAW = np.pi / 2
_Z = np.array([0.0, 0.0, 1.0])


@lru_cache(maxsize=None)
def _nut_mesh():
    """The nut mesh, its bottom face moved to z = 0."""
    v, t = load_obj(asset_path(f"{_MESH}/factory_nut_m16_tight_subdiv_3x.obj"))
    return v - np.array([0.0, 0.0, v[:, 2].min()]), t


@lru_cache(maxsize=None)
def _bolt_mesh():
    return load_obj(asset_path(f"{_MESH}/factory_bolt_m16_tight.obj"))


@lru_cache(maxsize=None)
def bolt_sdf_grid(resolution: int = 192):
    return mesh_to_sdf(*_bolt_mesh(), resolution=resolution, padding=0.08)


@lru_cache(maxsize=None)
def nut_sdf_grid(resolution: int = 96):
    return mesh_to_sdf(*_nut_mesh(), resolution=resolution, padding=0.12)


@lru_cache(maxsize=None)
def nut_contact_points():
    """The nut's candidate points in its frame: (12 rim corners, the
    thread-band points). Rims: per face, the farthest vertex from the axis
    (beyond 12.5 mm, within 0.6 mm of the face) in each 60-degree bin;
    thread: the bore's vertices 6.5-8.5 mm from the axis, picked 6 x 8 over
    (height, angle)."""
    v, _ = _nut_mesh()
    r = np.linalg.norm(v[:, :2], axis=1)
    rims = []
    for zsel in (v[:, 2] < 6e-4, v[:, 2] > NUT_HEIGHT - 6e-4):
        ring = v[zsel & (r > 0.0125)]
        ang = np.arctan2(ring[:, 1], ring[:, 0])
        for b in range(6):
            sel = np.where((ang >= -np.pi + b * np.pi / 3) & (ang < -np.pi + (b + 1) * np.pi / 3))[0]
            if len(sel):
                rims.append(ring[sel[np.argmax(np.linalg.norm(ring[sel, :2], axis=1))]])
    band = v[(r > 0.0065) & (r < 0.0085)]
    return np.asarray(rims, np.float32), _stratified_pick(band, n_z=6, n_ang=8)


def build_nut():
    """The free nut: hollow-cylinder inertials and a cylinder geom kept as
    metadata (its automatic points are stripped by the task)."""
    b = ModelBuilder()
    ro, ri, h = NUT_WIDTH_MAX / 2, BOLT_WIDTH / 2, NUT_HEIGHT
    m = np.pi * (ro ** 2 - ri ** 2) * h * DENSITY
    izz = 0.5 * m * (ro ** 2 + ri ** 2)
    ixx = m / 12.0 * (3 * (ro ** 2 + ri ** 2) + h ** 2)
    body = b.add_body(parent=-1, name="nut", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FREE, mass=m,
                      ipos=(0, 0, h / 2), inertia=np.diag([ixx, ixx, izz]))
    b.qpos0_free[body] = (np.array([0.0, 0.0, 0.0], np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(body, GEOM_CYLINDER, (0, 0, h / 2), (0, 0, 0, 1), (NUT_WIDTH_MIN / 2, h / 2, 0.0), friction=0.25)
    return b.finalize()


def build_bolt():
    """The bolt on two slide dofs (x, y) of armature and damping 1e4: held
    wherever the reset puts it (a fixed body could not vary per env)."""
    b = ModelBuilder()
    bx = b.add_body(parent=-1, name="bolt_x", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=SLIDE, jnt_axis=(1, 0, 0),
                    joint_name="bolt_slide_x", mass=1.0, armature=1e4, damping=1e4)
    b.add_body(parent=bx, name="bolt", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=SLIDE, jnt_axis=(0, 1, 0),
               joint_name="bolt_slide_y", mass=np.pi * (BOLT_WIDTH / 2) ** 2 * BOLT_TOP * DENSITY,
               armature=1e4, damping=1e4, ipos=(0, 0, BOLT_TOP / 2), inertia=np.eye(3) * 1e-4)
    return b.finalize()


def _pad_grid(zs, xs):
    """Pad points in a finger's frame: the pad face is its y = 0 plane."""
    return np.array([[sx, 0.0, z] for z in FINGER_LENGTH - FINGERPAD_LENGTH * np.asarray(zs) for sx in xs],
                    np.float32)


# the pads' points per finger: sparse where thread rows must keep their
# places among the 16 active ones (Screw), 4 x 5 to hold the nut in
# transport (Place), dense 6 x 7 so that closing fingers cannot sweep past
# a free nut's corner between points (Pick)
PAD_POINTS_SPARSE = _pad_grid([1.0, 0.5, 0.06], (-0.006, 0.006))
PAD_POINTS = _pad_grid([1.0, 0.75, 0.5, 0.25, 0.03], (-0.009, -0.003, 0.003, 0.009))
PAD_POINTS_DENSE = _pad_grid([1.0, 0.84, 0.68, 0.52, 0.36, 0.2, 0.03],
                             (-0.009, -0.0054, -0.0018, 0.0018, 0.0054, 0.009))


class NutBoltBase(VecTask):
    """The Franka, nut and bolt scene and the controllers of the family."""

    use_pd_targets = True
    ctrl_mode = "joint_space_id"
    gripper_target = 0.0  # closed (Place and Screw hold the nut)
    pad_points = PAD_POINTS_SPARSE

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        rl = cfg.get("rl", {})
        self.num_keypoints = int(rl.get("num_keypoints", 4))
        self.keypoint_scale = float(rl.get("keypoint_scale", 0.5))
        self.keypoint_reward_scale = float(rl.get("keypoint_reward_scale", 1.0))
        self.action_penalty_scale = float(rl.get("action_penalty_scale", 0.0))
        self.success_bonus = float(rl.get("success_bonus", 0.0))
        env.setdefault("episodeLength", int(rl.get("max_episode_length", 200)))
        self.rand_cfg = cfg.get("randomize", {})
        super().__init__(cfg, device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self.pos_action_scale = f32(rl.get("pos_action_scale", [0.1] * 3))
        self.rot_action_scale = f32(rl.get("rot_action_scale", [0.1] * 3))
        self._setup()

    # ---- model ---------------------------------------------------------
    def build_model(self):
        franka = load_urdf(asset_path("urdf/franka_description/robots/franka_panda.urdf"), fix_base=True)
        # base at (franka_depth, 0) on the floor 0.4 m below the table top, yaw pi
        bp = np.asarray(franka.body_pos).copy()
        bq = np.asarray(franka.body_quat).copy()
        bp[0] = [0.5, 0.0, -0.4]
        bq[0] = [0.0, 0.0, 1.0, 0.0]
        nv = franka.nv
        stiff = np.zeros(nv, np.float32)
        damp = np.zeros(nv, np.float32)
        stiff[nv - 2:] = 100.0  # the gripper's position drives
        damp[nv - 2:] = 2.0
        franka = franka.replace(body_pos=bp, body_quat=bq, dof_stiffness=stiff, dof_damping=damp)
        model, refs = compose([franka, build_nut(), build_bolt()], ["", "nut:", "bolt:"])
        self.franka_ref, self.nut_ref, self.bolt_ref = refs
        nut_body = self.nut_ref.body0
        lf = model.body_names.index("panda_leftfinger")
        rf = model.body_names.index("panda_rightfinger")
        model = _strip_points(model, set(range(model.nbody)))
        rims, thread = nut_contact_points()
        model, rim_idx = add_contact_points(model, nut_body, rims, friction=0.25)
        model, thr_idx = add_contact_points(model, nut_body, thread, friction=0.18)
        pads = np.asarray(self.pad_points)
        model, lf_idx = add_contact_points(model, lf, pads, friction=0.9)
        model, rf_idx = add_contact_points(model, rf, pads, friction=0.9)
        model, nut_g = attach_sdf(model, nut_body, nut_sdf_grid())
        model = pair_points_with_sdf(model, lf_idx + rf_idx, nut_g)
        self.bolt_body = self.bolt_ref.body0 + 1  # 'bolt', the child of 'bolt_x'
        model, bolt_g = attach_sdf(model, self.bolt_body, bolt_sdf_grid())
        model = pair_points_with_sdf(model, rim_idx + thr_idx, bolt_g)
        return model, self.sim_params_from_cfg()

    def _setup(self):
        m, dev = self.model, self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        nut_body = self.nut_ref.body0
        fr = [d for d in self.scalar_dof_indices if m.dof_body[d] < nut_body]  # arm 7, then the fingers
        self.q_idx = long([m.q_adr[m.dof_body[d]] for d in fr])
        self.v_idx = long(fr)
        self.arm = long(fr[:7])
        self.effort_limit = f32(np.asarray(m.dof_max_effort)[np.asarray(fr)][:7])
        self.hand_body = m.body_names.index("panda_hand")
        self.eef_offset = f32([0.0, 0.0, HAND_LENGTH + FINGER_LENGTH])
        self.pad_offset = f32([0.0, 0.0, HAND_LENGTH + FINGER_LENGTH - FINGERPAD_LENGTH / 2])
        self.nq = m.q_adr[nut_body]
        self.nvd = m.v_adr[nut_body]
        self.bolt_q = m.q_adr[self.bolt_ref.body0]
        self.kp = torch.full((7,), 40.0, device=dev)
        self.kd = torch.full((7,), 8.0, device=dev)
        # operational_space_motion (Screw's ctrl block) in the (angular,
        # linear) order of the increment: axes [0,0,1,0,0,1], gains [1,1,200,1,1,1]
        self.task_axes = f32([0.0, 0, 1, 0, 0, 1])
        self.task_kp = f32([1.0, 1, 200.0, 1, 1, 1])
        self.task_kd = torch.ones(6, device=dev)
        self._anc = f32(_dyn.ancestor_matrix(m))
        self._dof_mask = f32(_dyn.dof_ancestor_mask(m))
        self._dof_body = long(m.dof_body)
        self._ipos = f32(m.body_ipos)
        self._gravity = f32(self.sim_params.gravity)
        self._qpos0 = f32(m.qpos0)
        self._poses = _dyn.BodyPoses(m, dev)
        self.franka_mass = f32(np.where(np.arange(m.nbody) < nut_body, np.asarray(m.body_mass), 0.0))
        self._up = f32([0.0, 0.0, 1.0])
        self._half_nut = f32([0.0, 0.0, NUT_HEIGHT / 2])
        # a unit keypoint line centred at 0, scaled (factory_base _get_keypoint_offsets)
        z = torch.linspace(0.0, 1.0, self.num_keypoints, device=dev) - 0.5
        self.keypoint_offsets = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1) * self.keypoint_scale

    def _rand(self, generator, *shape):
        """Uniform draws in [-1, 1)."""
        return torch.rand(*shape, generator=generator, device=self.device) * 2.0 - 1.0

    # ---- shared state helpers -----------------------------------------
    def _fingertip(self, kin):
        """The fingertip midpoint's position, the hand's rotation, and the
        midpoint's linear and the hand's angular velocity."""
        h = self.hand_body
        x, qq, v = kin.x[:, h], kin.quat[:, h], kin.v[:, h]
        eef = x + maths.quat_rotate(qq, self.eef_offset.expand_as(x))
        return eef, qq, v[:, 3:] + torch.linalg.cross(v[:, :3], eef, dim=-1), v[:, :3]

    def _nut_state(self, q, qd):
        """The nut's base position, rotation, centre of mass, and its linear
        and angular velocity (the free joint's linear dofs store v - w x x)."""
        nq, nv = self.nq, self.nvd
        pos, quat = q[:, nq:nq + 3], q[:, nq + 3:nq + 7]
        com = pos + maths.quat_rotate(quat, self._half_nut.expand_as(pos))
        angvel = qd[:, nv + 3:nv + 6]
        return pos, quat, com, qd[:, nv:nv + 3] + torch.linalg.cross(angvel, com, dim=-1), angvel

    # ---- control -------------------------------------------------------
    def _scripted_overlay(self, actions, task):
        """The actions and gripper target in effect this step (Pick's
        scripted tail overrides them)."""
        return actions, self.gripper_target

    def compute_force(self, actions, q, qd, task):
        m, n = self.model, q.shape[0]
        action, grip = self._scripted_overlay(actions, task)
        kin = _dyn.forward_kinematics(m, q, qd)
        eef, _, elin, eang = self._fingertip(kin)
        dpos = action[:, 0:3] * self.pos_action_scale
        rot_act = action[:, 3:6]
        if self.ctrl_mode == "operational_space_motion":  # one-sided z rotation
            rot_act = torch.cat([rot_act[:, :2], -(rot_act[:, 2:3] + 1.0) * 0.5], -1)
        err = torch.cat([rot_act * self.rot_action_scale, dpos], -1)
        J = controllers.body_jacobian(kin, self._anc, self._dof_body, self.hand_body, eef)[:, :, self.arm]
        M = _dyn.mass_matrix(m, kin, (self._anc, self._dof_mask))
        M77 = M[:, self.arm][:, :, self.arm]
        qd7 = qd[:, self.arm]
        if self.ctrl_mode == "operational_space_motion":
            body_vel = torch.cat([eang, elin], -1)
            tau = controllers.operational_space_control(J, torch.linalg.inv_ex(M77)[0], err * self.task_axes,
                                                        body_vel * self.task_axes, qd7, self.task_kp, self.task_kd)
        else:  # joint_space_id: damped least-squares IK, then a joint PD through M
            dq = controllers.get_delta_dof_pos(err, J, method="dls", lam=0.1)
            tau = controllers.joint_space_pd(self.kp * dq, qd7, 1.0, self.kd, mass_matrix=M77)
        tau = torch.clamp(tau, -self.effort_limit, self.effort_limit)
        qfrc = q.new_zeros(n, m.nv)
        qfrc[:, self.arm] = tau
        # the Franka's weight taken back at each body's centre of mass
        com = kin.x + maths.quat_rotate(kin.quat, self._ipos.expand(n, -1, -1))
        f = (-self.franka_mass[:, None] * self._gravity[None, :]).expand(n, -1, -1)
        xfrc = torch.cat([torch.linalg.cross(com, f, dim=-1), f], dim=-1)
        q_target = q.new_zeros(n, m.nq)
        q_target[:, self.q_idx[7:]] = torch.as_tensor(grip, dtype=q.dtype, device=q.device).reshape(-1, 1).expand(n, 2)
        return qfrc, xfrc, q_target

    # ---- comparison states ----------------------------------------------
    def contact_states(self, n: int, seed: int, kinds=("held", "thread", "head", "table")):
        """n states (q, qd) in which the nut's and the pads' rows act, for
        holding the kernel against its plain version, the kinds in turn:
        `held`, the nut between the closed pads at their midpoint (flats
        against the pads, the pads 0.1-0.3 mm into them, the nut 0-1 mm off
        the midpoint, yawed by up to 2 degrees off the flats and tilted by
        0.5-1.5 degrees, so that no two pad points lie at one depth), the bolt
        moved 8 cm away; `thread`, the nut on the bolt's thread 4-20 mm
        above the head, on the helix, 0-0.1 mm below its centred pose so
        that its lower flanks bear, tilted by up to 0.2 degrees; `head`, the
        nut screwed down onto the head, 0-0.2 mm into it; `table`, the nut on
        the table, a corner 0-0.3 mm into it, tilted by 1-3 degrees (so that
        no two rims tie), the bolt beside it. Outside `held` the bolt stands
        8 cm from the pads' midpoint and the fingers are open 34-38 mm (clear
        of their limit at 40 mm). The arm lies within 0.02 rad of the task's
        reset pose; gentle velocities. Drawn with numpy from `seed`."""
        m, rng, dev = self.model, np.random.RandomState(seed), self.device
        q = np.tile(np.asarray(m.qpos0, np.float64), (n, 1))
        q_idx = self.q_idx.cpu().numpy()
        q[:, q_idx[:7]] = self.arm_init.cpu().numpy() + rng.uniform(-0.02, 0.02, (n, 7))
        kind = [kinds[i % len(kinds)] for i in range(n)]
        held = np.asarray([k == "held" for k in kind])
        q[:, q_idx[7:]] = rng.uniform(0.034, 0.038, (n, 1))  # open, clear of the limit at 0.04
        q[held, q_idx[7]] = q[held, q_idx[8]] = NUT_WIDTH_MIN / 2 - rng.uniform(1e-4, 3e-4, int(held.sum()))
        x, quat = (t.double().cpu().numpy() for t in self._poses(torch.as_tensor(q, dtype=torch.float32, device=dev)))
        hx, hq = x[:, self.hand_body], quat[:, self.hand_body]
        nq, bq, pad_offset = self.nq, self.bolt_q, self.pad_offset.cpu().numpy()
        for i in range(n):
            pad_mid = hx[i] + _qrot_np(hq[i], pad_offset)
            away = rng.uniform(0, 2 * np.pi)
            bolt_xy = pad_mid[:2] + 0.08 * np.array([np.cos(away), np.sin(away)])
            q[i, bq:bq + 2] = bolt_xy
            tilt_axis = np.array([*rng.normal(size=2), 0.0])
            tilt_axis /= np.linalg.norm(tilt_axis)
            tilt = lambda deg: _quat_np(tilt_axis, np.deg2rad(deg))
            if kind[i] == "held":
                hand_yaw = float(maths.get_euler_xyz(torch.tensor(hq[i]))[2])
                yaw = hand_yaw + NUT_GRIP_YAW + np.deg2rad(rng.uniform(-2, 2))
                pos = pad_mid - np.array([0.0, 0.0, NUT_HEIGHT / 2]) + np.array([0, 0, 1.0]) * rng.uniform(-1e-3, 1e-3)
                quat_n = _qmul_np(tilt(rng.uniform(0.5, 1.5)), _quat_np(_Z, yaw))
            elif kind[i] in ("thread", "head"):
                # on the helix through the meshes' in-mesh pose (z 0.0405 at 30 degrees)
                z = (BOLT_HEAD_HEIGHT + rng.uniform(0.004, 0.020) if kind[i] == "thread"
                     else BOLT_HEAD_HEIGHT)
                yaw = np.pi / 6 + 2 * np.pi * (z - 0.0405) / THREAD_PITCH
                z -= rng.uniform(0.0, 1e-4) if kind[i] == "thread" else rng.uniform(0.0, 2e-4)
                pos = np.array([*bolt_xy, z])
                quat_n = _qmul_np(tilt(rng.uniform(0.0, 0.2)), _quat_np(_Z, yaw))
            else:  # on the table, beside the bolt
                quat_n = _qmul_np(tilt(rng.uniform(1.0, 3.0)), _quat_np(_Z, rng.uniform(-np.pi, np.pi)))
                rims, _ = nut_contact_points()
                low = min(_qrot_np(quat_n, r)[2] for r in rims)
                side = away + np.pi / 2
                pos = np.array([*(bolt_xy + 0.04 * np.array([np.cos(side), np.sin(side)])),
                                -low - rng.uniform(0.0, 3e-4)])
            q[i, nq:nq + 3], q[i, nq + 3:nq + 7] = pos, quat_n
        qd = rng.uniform(-0.01, 0.01, (n, m.nv))
        qd[:, self.nvd:self.nvd + 6] *= 0.1
        return torch.tensor(q, dtype=torch.float32, device=dev), torch.tensor(qd, dtype=torch.float32, device=dev)


class FactoryTaskNutBoltPick(NutBoltBase):
    """Reach for the nut on the table and grasp it (reference
    factory_task_nut_bolt_pick.py): 20 observations (fingertip midpoint
    pose and velocities, the nut's grasp pose), 12 actions, the keypoint
    reward between the gripper's and the grasp pose's keypoint lines, and
    the scripted close-and-lift tail after the acting steps."""

    ctrl_mode = "joint_space_id"
    gripper_target = 0.04  # open while acting
    pad_points = PAD_POINTS_DENSE

    def __init__(self, cfg, device="cuda"):
        rl = cfg.get("rl", {})
        envc = cfg.setdefault("env", {})
        self.close_and_lift = bool(envc.get("close_and_lift", True))
        self.close_steps = int(envc.get("num_gripper_close_sim_steps", 25))
        self.lift_steps = int(envc.get("num_gripper_lift_sim_steps", 25))
        # acting steps: env.episodeLength when given, else rl.max_episode_length;
        # the episode appends the scripted tail (not written back into cfg)
        env_len = envc.get("episodeLength")
        self.rl_len = int(env_len if env_len is not None else rl.get("max_episode_length", 100))
        scripted = self.close_steps + self.lift_steps if self.close_and_lift else 0
        self.num_obs = 20
        self.num_acts = 12
        super().__init__(cfg, device)
        self.max_episode_length = self.rl_len + scripted
        r, f32 = self.rand_cfg, lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        self.arm_init = f32(r.get("franka_arm_initial_dof_pos",
                                  [0.3413, -0.8011, -0.0670, -1.8299, 0.0266, 1.0185, 1.0927]))
        self.nut_xy_init = f32(r.get("nut_pos_xy_initial", [0.0, -0.3]))
        self.nut_xy_noise = f32(r.get("nut_pos_xy_initial_noise", [0.1, 0.1]))
        self.bolt_xy_init = f32(r.get("bolt_pos_xy_initial", [0.0, 0.0]))
        self.bolt_xy_noise = f32(r.get("bolt_pos_xy_noise", [0.1, 0.1]))
        self.arm_joint_noise = float(r.get("arm_joint_noise", 0.02))
        self.down_quat = f32([1.0, 0.0, 0.0, 0.0])  # fingers down onto the nut's top face

    def sample_init(self, generator, n):
        q = self._qpos0.repeat(n, 1)
        q[:, self.q_idx[:7]] = self.arm_init + self.arm_joint_noise * self._rand(generator, n, 7)
        q[:, self.q_idx[7:]] = self.gripper_target
        nq = self.nq
        q[:, nq:nq + 2] = self.nut_xy_init + self.nut_xy_noise * self._rand(generator, n, 2)
        q[:, nq + 2] = 0.0  # the nut's base on the table
        yaw = np.pi * self._rand(generator, n)
        q[:, nq + 3:nq + 7] = maths.quat_from_angle_axis(yaw, self._up.expand(n, 3))
        q[:, self.bolt_q:self.bolt_q + 2] = self.bolt_xy_init + self.bolt_xy_noise * self._rand(generator, n, 2)
        return q, q.new_zeros(n, self.model.nv), {"t": torch.zeros(n, dtype=torch.int32, device=self.device)}

    # ---- the scripted close-and-lift tail -----------------------------
    def _phase(self, cur):
        """(in_close, in_lift) at progress `cur`: acting steps are 1 ..
        rl_len - 1, then close_steps closing and lift_steps lifting."""
        lift_start = self.rl_len + self.close_steps
        return (cur >= self.rl_len) & (cur < lift_start), cur >= lift_start

    def _scripted_overlay(self, actions, task):
        if not self.close_and_lift:
            return actions, self.gripper_target
        in_close, in_lift = self._phase(task["t"] + 1)  # task["t"]: the progress recorded last step
        scripted = (in_close | in_lift)[:, None]
        a = torch.where(scripted, torch.zeros_like(actions), actions)
        # open-loop lift: a 0.3 m z target offset per step (reference _lift_gripper)
        a = torch.cat([a[:, :2], torch.where(in_lift, 0.3 / self.pos_action_scale[2], a[:, 2])[:, None], a[:, 3:]], -1)
        grip = torch.where(scripted[:, 0], 0.0, self.gripper_target)
        return a, grip

    # ---- observations and reward ------------------------------------------
    def _grasp_pose(self, q):
        nq = self.nq
        return (q[:, nq:nq + 3] + self._half_nut,
                maths.quat_mul(q[:, nq + 3:nq + 7], self.down_quat.expand(q.shape[0], 4)))

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        eef, eq, elin, eang = self._fingertip(kin)
        return torch.cat([eef, eq, elin, eang, *self._grasp_pose(q)], -1)

    def _keypoint_dist(self, q, kin):
        n, k = q.shape[0], self.num_keypoints
        eef, eq, _, _ = self._fingertip(kin)
        grasp_pos, grasp_quat = self._grasp_pose(q)
        off = self.keypoint_offsets.expand(n, k, 3)
        kp_gripper = eef[:, None] + maths.quat_rotate(eq[:, None].expand(n, k, 4), off)
        kp_nut = grasp_pos[:, None] + maths.quat_rotate(grasp_quat[:, None].expand(n, k, 4), off)
        return torch.sum(torch.linalg.vector_norm(kp_nut - kp_gripper, dim=-1), -1)

    def _lift_success(self, q):
        """The nut's base above 3 nut heights (_check_lift_success)."""
        return (q[:, self.nq + 2] > 3.0 * NUT_HEIGHT).float()

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        reward = (-self._keypoint_dist(q, kin) * self.keypoint_reward_scale
                  - torch.linalg.vector_norm(actions, dim=-1) * self.action_penalty_scale)
        if self.close_and_lift:
            in_close, in_lift = self._phase(progress)
            reward = torch.where(in_close | in_lift, 0.0, reward)
        last = progress >= self.max_episode_length - 1
        reward = reward + torch.where(last, self._lift_success(q) * self.success_bonus, 0.0)
        return reward, last, {"t": progress}

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        last = progress >= self.max_episode_length - 1
        return {"successes": torch.where(last, self._lift_success(q), 0.0)}

    def true_objective(self, q, qd):
        return -torch.linalg.vector_norm(q[:, self.nq:self.nq + 3] + self._half_nut, dim=-1)


class FactoryTaskNutBoltPlace(NutBoltBase):
    """Carry the gripped nut onto the bolt's tip (reference
    factory_task_nut_bolt_place.py): 27 observations, 12 actions, the
    keypoint reward between the nut's axis (from its base) and the bolt's
    (from its tip)."""

    ctrl_mode = "joint_space_id"
    pad_points = PAD_POINTS

    def __init__(self, cfg, device="cuda"):
        rl = cfg.get("rl", {})
        cfg.setdefault("env", {})
        self.close_error_thresh = float(rl.get("close_error_thresh", 0.1))
        self.num_obs = 27
        self.num_acts = 12
        super().__init__(cfg, device)
        r, f32 = self.rand_cfg, lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        self.arm_init = f32(r.get("franka_arm_initial_dof_pos",
                                  [0.00871, -0.10368, -0.00794, -1.49139, -0.00083, 1.38774, 0.7861]))
        self.nut_noise_pos = f32(r.get("nut_noise_pos_in_gripper", [0.0, 0.0, 0.01]))
        self.nut_noise_rot = float(r.get("nut_noise_rot_in_gripper", 0.0))
        self.bolt_xy_init = f32(r.get("bolt_pos_xy_initial", [0.0, 0.0]))
        self.bolt_xy_noise = f32(r.get("bolt_pos_xy_noise", [0.1, 0.1]))
        self.arm_joint_noise = float(r.get("arm_joint_noise", 0.06))
        self._bolt_quat = f32([0.0, 0.0, 0.0, 1.0])

    def sample_init(self, generator, n):
        """The arm's reset pose with joint noise (standing in for the
        reference's scripted gripper-pose randomization), the fingers
        closed on the nut's flats, the nut at the pads' midpoint (the
        forward kinematics of the reset pose) yawed by pi/2 from the hand."""
        q = self._qpos0.repeat(n, 1)
        q[:, self.q_idx[:7]] = self.arm_init + self.arm_joint_noise * self._rand(generator, n, 7)
        q[:, self.q_idx[7:]] = NUT_WIDTH_MIN / 2 - 1e-4
        q[:, self.bolt_q:self.bolt_q + 2] = self.bolt_xy_init + self.bolt_xy_noise * self._rand(generator, n, 2)
        x, quat = self._poses(q)
        hx, hq = x[:, self.hand_body], quat[:, self.hand_body]
        pad_mid = hx + maths.quat_rotate(hq, self.pad_offset.expand(n, 3))
        noise = self.nut_noise_pos * self._rand(generator, n, 3)
        yaw = maths.get_euler_xyz(hq)[2] + NUT_GRIP_YAW + self.nut_noise_rot * self._rand(generator, n)
        nq = self.nq
        q[:, nq:nq + 3] = pad_mid - self._half_nut + noise
        q[:, nq + 3:nq + 7] = maths.quat_from_angle_axis(yaw, self._up.expand(n, 3))
        return q, q.new_zeros(n, self.model.nv), ()

    def _keypoints(self, q):
        """Keypoints on the nut's axis (from its base) and the bolt's (from its tip)."""
        n, k, nq = q.shape[0], self.num_keypoints, self.nq
        off = self.keypoint_offsets.expand(n, k, 3)
        kp_nut = q[:, None, nq:nq + 3] + maths.quat_rotate(q[:, None, nq + 3:nq + 7].expand(n, k, 4), off)
        bolt_tip = torch.cat([q[:, self.bolt_q:self.bolt_q + 2], q.new_full((n, 1), BOLT_TOP)], -1)
        return kp_nut, bolt_tip[:, None] + off

    def _dist(self, q):
        kp_nut, kp_bolt = self._keypoints(q)
        return torch.sum(torch.linalg.vector_norm(kp_bolt - kp_nut, dim=-1), -1)

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        n = q.shape[0]
        eef, eq, elin, eang = self._fingertip(kin)
        nut_pos, nut_quat = q[:, self.nq:self.nq + 3], q[:, self.nq + 3:self.nq + 7]
        bolt_pos = torch.cat([q[:, self.bolt_q:self.bolt_q + 2], q.new_zeros(n, 1)], -1)
        return torch.cat([eef, eq, elin, eang, nut_pos, nut_quat, bolt_pos, self._bolt_quat.expand(n, 4)], -1)

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        dist = self._dist(q)
        reward = (-dist * self.keypoint_reward_scale
                  - torch.linalg.vector_norm(actions, dim=-1) * self.action_penalty_scale)
        last = progress >= self.max_episode_length - 1
        success = (dist < self.close_error_thresh).float()
        return reward + torch.where(last, success * self.success_bonus, 0.0), last, task

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        return {"successes": (self._dist(q) < self.close_error_thresh).float()}

    def true_objective(self, q, qd):
        return -self._dist(q)


class FactoryTaskNutBoltScrew(NutBoltBase):
    """Screw the gripped nut down the bolt (reference
    factory_task_nut_bolt_screw.py): 32 observations (26 and zero padding),
    12 actions, operational-space z motion with the one-sided z rotation;
    success within one pitch of the fully screwed height."""

    ctrl_mode = "operational_space_motion"

    def __init__(self, cfg, device="cuda"):
        rl = cfg.get("rl", {})
        cfg.setdefault("env", {})
        rl.setdefault("max_episode_length", 1024)
        self.far_error_thresh = float(rl.get("far_error_thresh", 0.1))
        self.num_obs = 32
        self.num_acts = 12
        super().__init__(cfg, device)
        r, f32 = self.rand_cfg, lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        self.arm_init = f32(r.get("franka_arm_initial_dof_pos",
                                  [1.5178e-03, -1.9651e-01, -1.4364e-03, -1.9761, -2.7717e-04, 1.7796, 7.8556e-01]))
        self.nut_rot_initial = float(r.get("nut_rot_initial", 30.0))
        # the nut's centre of mass fully screwed: head height + half the nut's
        self.target_pos = f32([0.0, 0.0, BOLT_HEAD_HEIGHT + NUT_HEIGHT * 0.5])
        self._axis = f32([0.0, 0.0, HAND_LENGTH + FINGER_LENGTH])
        self._lin = torch.linspace(0.0, 1.0, 4, device=self.device)[None, :, None]

    def sample_init(self, generator, n):
        """The fingers open by the reference's 1.1 buffer (the closed
        gripper target squeezes them shut), the nut's base at the bolt's
        top less 0.5 mm (seated in the groove), yawed nut_rot_initial."""
        q = self._qpos0.repeat(n, 1)
        q[:, self.q_idx[:7]] = self.arm_init
        q[:, self.q_idx[7:]] = NUT_WIDTH_MAX / 2 * 1.1
        nq = self.nq
        q[:, nq:nq + 3] = torch.tensor([0.0, 0.0, BOLT_TOP - 5e-4], device=self.device)
        yaw = torch.full((n,), self.nut_rot_initial * np.pi / 180.0, device=self.device)
        q[:, nq + 3:nq + 7] = maths.quat_from_angle_axis(yaw, self._up.expand(n, 3))
        return q, q.new_zeros(n, self.model.nv), ()

    def _keypoint_dists(self, q, qd, kin):
        """Keypoint distances nut-to-target and finger-to-nut (4 points
        along axes of hand + finger length), the nut's centre of mass and
        the pads' midpoint."""
        n = q.shape[0]
        _, eq, _, _ = self._fingertip(kin)
        _, nut_quat, nut_com, _, _ = self._nut_state(q, qd)
        seg = lambda p1, p2: p1[:, None] + (p2 - p1)[:, None] * self._lin
        axis = self._axis.expand(n, 3)
        nut_axis2 = nut_com + maths.quat_rotate(nut_quat, axis)
        kp_nut = seg(nut_com, nut_axis2)
        target = self.target_pos.expand(n, 3)
        nut_kp = torch.sum(torch.linalg.vector_norm(seg(target, target + axis) - kp_nut, dim=-1), -1)
        h = self.hand_body
        pad_mid = kin.x[:, h] + maths.quat_rotate(kin.quat[:, h], self.pad_offset.expand(n, 3))
        kp_f = seg(pad_mid, pad_mid + maths.quat_rotate(eq, -axis))
        fn_kp = torch.sum(torch.linalg.vector_norm(kp_nut - kp_f, dim=-1), -1)
        return nut_kp, fn_kp, nut_com, pad_mid

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        eef, eq, elin, eang = self._fingertip(kin)
        _, nut_quat, nut_com, nlin, nang = self._nut_state(q, qd)
        obs = torch.cat([eef, eq, elin, eang, nut_com, nut_quat, nlin, nang], -1)
        return torch.cat([obs, obs.new_zeros(q.shape[0], self.num_obs - obs.shape[1])], -1)

    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        nut_kp, fn_kp, nut_com, pad_mid = self._keypoint_dists(q, qd, kin)
        reward = (-(nut_kp + fn_kp) * self.keypoint_reward_scale
                  - torch.linalg.vector_norm(actions, dim=-1) * self.action_penalty_scale)
        dist = torch.linalg.vector_norm(self.target_pos - nut_com, dim=-1)
        success = dist < THREAD_PITCH
        reward = reward + success * self.success_bonus
        # failures (reference :352-386): time, far, slipped out of the pads, fallen off the bolt
        expired = progress >= self.max_episode_length - 1
        far = dist > self.far_error_thresh
        slipped = ((torch.linalg.vector_norm(pad_mid - nut_com, dim=-1) > FINGERPAD_LENGTH * 0.5 + NUT_HEIGHT * 0.5)
                   & ~success)
        fallen = ((torch.linalg.vector_norm(nut_com[:, :2], dim=-1) > BOLT_WIDTH * 0.5)
                  & (nut_com[:, 2] < BOLT_TOP + NUT_HEIGHT * 0.5))
        return reward, success | expired | far | slipped | fallen, task

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        """`successes` and `descent`, the nut's run down the helix from its
        reset seat (the episode's progress metric: a full screw is out of
        reach of the wrist's travel in one episode)."""
        _, _, nut_com, _ = self._keypoint_dists(q, qd, kin)
        success = torch.linalg.vector_norm(self.target_pos - nut_com, dim=-1) < THREAD_PITCH
        return {"successes": success.float(), "descent": (BOLT_TOP - 5e-4) - q[:, self.nq + 2]}

    def true_objective(self, q, qd):
        return -torch.abs(q[:, self.nq + 2] + NUT_HEIGHT / 2 - self.target_pos[2])
