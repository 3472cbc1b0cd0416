"""IndustRealTaskPegsInsert (port of
isaacgymenvs_tpu/tasks/industreal_pegs_insert.py), batched over envs:
insert a gripped 8 mm round peg into its tray insert, with the SAPU-scaled
SDF reward, the engagement bonus and the sampling-based curriculum (SBC)
over the initial insertion depth (tasks/industreal_algo.py).

A Franka (the Panda stand-in, its base at the world origin facing +x; z = 0
is the table top) holds the plug, a free body; the socket stands on three
slides (x, y, z) and a yaw hinge of armature and damping 1e4, which hold it
wherever the reset puts it. Every automatic candidate point is stripped.
The plug's 76 points (dense rings near its tip, sparser ones up its shaft)
are paired with the socket's SDF grid, and both fingers' 2 x 3 pad points
with the plug's grid; every point is also a table-plane row. The cfg caps
the active set at 32 of the 176 rows.

The arm is driven through its 7 joint torques by task-space impedance on
the fingertip midpoint (the actions' six components, (linear, angular),
scaled by 0.01; the increment runs (angular, linear) as the JAX package
orders it; the z rotation is read one-sided, -(a + 1) / 2). Torques are
clipped to the effort limits, every Franka body takes its weight back as a
wrench at its centre of mass (the reference disables the robot's gravity),
and the fingers' position drives (stiffness 500, damping 2) close on the
plug. The reset places the socket (xy and z noise, yaw), drops the plug
into it by the curriculum's displacement (xy noise only above the socket),
puts the fingers at the plug's radius less 0.1 mm and runs 24 damped
least-squares IK iterations of the arm to the grasp pose, for every env, in
each step where some env resets (`costly_reset`: the JAX package runs it
every step and selects the resets with a where, which gives the same
states).

The observation (24): arm joints, fingertip position and rotation, the
noisy gripper goal above the socket (a per-episode perception bias), the
socket's rotation and the goal's offset from the fingertip. The privileged
state (47) adds velocities, the true goal and the plug's pose. The reward:
10 x the SDF reward, scaled by SAPU's 1 - tanh(depth / 1 mm), or the last
reward where the plug's sample points reach deeper into the socket than
1 mm; at the episode's last step the engagement bonus and the curriculum's
scale. Each step the population's insertion success over the envs that end
their episode moves the shared max displacement (`population_update`).

The meshes are stand-ins written by
assets/industreal/make_industreal_meshes.py (the JAX package reads the same
files through $ISAACGYMENVS_TPU_ASSETS).
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
from ..model.spec import FREE, GEOM_CYLINDER, HINGE, SLIDE, ModelBuilder
from ..sdf.builder import add_contact_points, attach_sdf, load_obj, mesh_to_sdf, pair_points_with_sdf
from ..utils.assets import asset_path
from . import industreal_algo as algo
from .factory_common import _stratified_pick, _strip_points
from .factory_nut_bolt import FINGER_LENGTH, HAND_LENGTH, PAD_POINTS_SPARSE
from .franka_cube_stack import _qmul_np, _qrot_np, _quat_np

# industreal_asset_info_pegs.yaml round_peg_hole_8mm
PLUG_DIAMETER = 0.007986
PLUG_LENGTH = 0.050
PLUG_DENSITY = 8000.0
PLUG_GRASP_OFFSET = 0.04
PLUG_BASE_Z = 0.003  # the peg mesh's bottom in the shared OBJ frame
SOCKET_HEIGHT = 0.028  # the tray insert's height
SOCKET_DENSITY = 8000.0

_MESH = "industreal/mesh/industreal_pegs"
PLUG_OBJ = f"{_MESH}/industreal_round_peg_8mm.obj"
SOCKET_OBJ = f"{_MESH}/industreal_tray_insert_round_peg_8mm.obj"


@lru_cache(maxsize=None)
def _plug_mesh():
    return load_obj(asset_path(PLUG_OBJ))


@lru_cache(maxsize=None)
def _socket_mesh():
    return load_obj(asset_path(SOCKET_OBJ))


@lru_cache(maxsize=None)
def socket_sdf_grid(resolution: int = 192):
    """The tray insert's grid (the URDF's `<sdf resolution="256"/>`)."""
    return mesh_to_sdf(*_socket_mesh(), resolution=resolution, padding=0.08)


@lru_cache(maxsize=None)
def plug_sdf_grid(resolution: int = 128):
    return mesh_to_sdf(*_plug_mesh(), resolution=resolution, padding=0.15)


@lru_cache(maxsize=None)
def plug_sample_points(n_z: int = 16, n_ang: int = 16):
    """The stratified vertex sample of SAPU and the SDF reward (the
    reference samples 1000 points evenly on the mesh)."""
    v, _ = _plug_mesh()
    return _stratified_pick(v.astype(np.float32), n_z=n_z, n_ang=n_ang)


@lru_cache(maxsize=None)
def plug_contact_points():
    """The plug's candidate points: dense rings near the tip (the hole's
    mouth and chamfer), sparser ones up the shaft."""
    v, _ = _plug_mesh()
    tip = v[v[:, 2] < PLUG_BASE_Z + 0.006]
    shaft = v[v[:, 2] >= PLUG_BASE_Z + 0.006]
    return np.concatenate([
        _stratified_pick(tip.astype(np.float32), n_z=3, n_ang=12),
        _stratified_pick(shaft.astype(np.float32), n_z=5, n_ang=8),
    ])


def build_plug():
    b = ModelBuilder()
    r, h = PLUG_DIAMETER / 2, PLUG_LENGTH
    m = np.pi * r * r * h * PLUG_DENSITY
    izz = 0.5 * m * r * r
    ixx = m / 12.0 * (3 * r * r + h * h)
    body = b.add_body(parent=-1, name="plug", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FREE, mass=m,
                      ipos=(0, 0, PLUG_BASE_Z + h / 2), inertia=np.diag([ixx, ixx, izz]))
    b.qpos0_free[body] = (np.array([0.5, 0.0, SOCKET_HEIGHT], np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(body, GEOM_CYLINDER, (0, 0, PLUG_BASE_Z + h / 2), (0, 0, 0, 1), (r, h / 2, 0.0), friction=1.0)
    return b.finalize()


def build_socket():
    """The socket on x / y / z slides and a yaw hinge of armature and
    damping 1e4, so that each env's reset q places it (the reference
    randomizes its xy, its z in [0, 0.05] and its yaw)."""
    b = ModelBuilder()
    parent = -1
    for name, ax in zip(("socket_x", "socket_y", "socket_z"), ((1, 0, 0), (0, 1, 0), (0, 0, 1))):
        parent = b.add_body(parent=parent, name=name, pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=SLIDE,
                            jnt_axis=ax, joint_name=name + "_slide", mass=1.0, armature=1e4, damping=1e4)
    ro = 0.0283
    m = np.pi * ro * ro * SOCKET_HEIGHT * SOCKET_DENSITY
    b.add_body(parent=parent, name="socket", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=HINGE,
               jnt_axis=(0, 0, 1), joint_name="socket_yaw", mass=m, armature=1e4, damping=1e4,
               ipos=(0, 0, SOCKET_HEIGHT / 2), inertia=np.eye(3) * 1e-3)
    return b.finalize()


def franka_for_industreal():
    """The Panda stand-in at the origin with the gripper's position drives
    (ctrl.all gripper_prop_gains 500, gripper_deriv_gains 2)."""
    franka = load_urdf(asset_path("urdf/franka_description/robots/franka_panda.urdf"), fix_base=True)
    nv = franka.nv
    stiff = np.zeros(nv, np.float32)
    damp = np.zeros(nv, np.float32)
    stiff[nv - 2:] = 500.0
    damp[nv - 2:] = 2.0
    return franka.replace(dof_stiffness=stiff, dof_damping=damp)


class IndustRealTaskPegsInsert(VecTask):
    """Peg insertion with the SAPU-scaled SDF reward, the engagement bonus
    and the sampling-based curriculum over the initial insertion depth."""

    use_pd_targets = True
    costly_reset = True  # the reset's IK: five in six of the step's device ops
    # uniform draws per env of the reset, by name and width (the JAX
    # package's six keys of `_sample`)
    DRAWS = (("socket_xy", 2), ("socket_z", 1), ("socket_yaw", 1), ("disp", 1), ("plug_xy", 2), ("obs_noise", 3))

    def __init__(self, cfg, device="cuda"):
        env = cfg.setdefault("env", {})
        rl = cfg.get("rl", {})
        r = cfg.get("randomize", {})
        self.num_obs = int(env.get("numObservations", 24))
        self.num_acts = int(env.get("numActions", 6))
        self.num_states = int(env.get("numStates", 47))
        env.setdefault("episodeLength", int(rl.get("max_episode_length", 256)))
        self.socket_base_height = float(env.get("socket_base_height", 0.003))
        self.unidirectional_rot = bool(rl.get("unidirectional_rot", True))
        self.num_keypoints = int(rl.get("num_keypoints", 4))
        self.keypoint_scale = float(rl.get("keypoint_scale", 0.5))
        # SAPU, the SDF reward, SBC (IndustRealTaskPegsInsert.yaml rl:)
        self.interpen_thresh = float(rl.get("interpen_thresh", 0.001))
        self.sdf_reward_scale = float(rl.get("sdf_reward_scale", 10.0))
        self.initial_max_disp = float(rl.get("initial_max_disp", 0.01))
        self.curriculum_success_thresh = float(rl.get("curriculum_success_thresh", 0.75))
        self.curriculum_failure_thresh = float(rl.get("curriculum_failure_thresh", 0.5))
        self.close_error_thresh = float(rl.get("close_error_thresh", 0.15))
        self.success_height_thresh = float(rl.get("success_height_thresh", 0.003))
        self.engagement_bonus = float(rl.get("engagement_bonus", 10.0))
        super().__init__(cfg, device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self.socket_pos_obs_noise = f32(env.get("socket_pos_obs_noise", [0.001, 0.001, 0.0]))
        self.pos_action_scale = f32(rl.get("pos_action_scale", [0.01] * 3))
        self.rot_action_scale = f32(rl.get("rot_action_scale", [0.01] * 3))
        self.curriculum_height_step = f32(rl.get("curriculum_height_step", [-0.005, 0.003]))
        self.curriculum_height_bound = f32(rl.get("curriculum_height_bound", [-0.01, 0.01]))
        self.arm_init = f32(r.get("franka_arm_initial_dof_pos",
                                  [-1.75748, 0.84032, 2.01588, -2.09249, -0.73794, 1.62564, 1.26893]))
        self.socket_xy_initial = f32(r.get("socket_pos_xy_initial", [0.5, 0.0]))
        self.socket_xy_noise = f32(r.get("socket_pos_xy_noise", [0.1, 0.1]))
        self.socket_z_bounds = f32(r.get("socket_pos_z_noise_bounds", [0.0, 0.05]))
        self.socket_rot_noise = float((r.get("socket_rot_noise") or [0, 0, 0.0872665])[2])
        self.plug_xy_noise = f32(r.get("plug_pos_xy_noise", [0.01, 0.01]))
        self._setup()

    # ---- model ---------------------------------------------------------
    def _actors(self):
        return [franka_for_industreal(), build_plug(), build_socket()], ["", "plug:", "socket:"]

    def _add_contacts(self, model, plug_body, socket_body, lf, rf):
        """The plug's points against the socket's grid; the pads against the plug's."""
        model, cp_idx = add_contact_points(model, plug_body, plug_contact_points(), friction=0.5)
        model, socket_g = attach_sdf(model, socket_body, socket_sdf_grid())
        model = pair_points_with_sdf(model, cp_idx, socket_g)
        model, lf_idx = add_contact_points(model, lf, PAD_POINTS_SPARSE, friction=1.0)
        model, rf_idx = add_contact_points(model, rf, PAD_POINTS_SPARSE, friction=1.0)
        model, plug_g = attach_sdf(model, plug_body, plug_sdf_grid())
        return pair_points_with_sdf(model, lf_idx + rf_idx, plug_g)

    def build_model(self):
        model, refs = compose(*self._actors())
        self.franka_ref, self.plug_ref, self.socket_ref = refs
        plug_body = self.plug_ref.body0
        socket_body = self.socket_ref.body0 + 3  # the yaw child of the three slides
        lf = model.body_names.index("panda_leftfinger")
        rf = model.body_names.index("panda_rightfinger")
        model = _strip_points(model, set(range(model.nbody)))
        model = self._add_contacts(model, plug_body, socket_body, lf, rf)
        self.plug_body, self.socket_body = plug_body, socket_body
        return model, self.sim_params_from_cfg()

    def _setup(self):
        m, dev = self.model, self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        fr = [d for d in self.scalar_dof_indices if m.dof_body[d] < self.plug_ref.body0]  # arm 7, the fingers
        self.q_idx = long([m.q_adr[m.dof_body[d]] for d in fr])
        self.v_idx = long(fr)
        self.arm = long(fr[:7])
        self.effort_limit = f32(np.asarray(m.dof_max_effort)[np.asarray(fr)][:7])
        self.hand_body = m.body_names.index("panda_hand")
        self.eef_offset = f32([0.0, 0.0, HAND_LENGTH + FINGER_LENGTH])
        self.pq = m.q_adr[self.plug_body]
        self.pv = m.v_adr[self.plug_body]
        self.sq = m.q_adr[self.socket_ref.body0]  # the three slides, then the yaw hinge
        # task-space impedance gains: the cfg lists (linear, angular), the
        # Jacobian's and the error's rows run (angular, linear)
        ctrl = (self.cfg.get("ctrl") or {}).get("task_space_impedance", {})
        kp = list(ctrl.get("task_prop_gains", [300, 300, 300, 50, 50, 50]))
        kd = list(ctrl.get("task_deriv_gains", [34, 34, 34, 1.4, 1.4, 1.4]))
        self.task_kp = f32(kp[3:] + kp[:3])
        self.task_kd = f32(kd[3:] + kd[:3])
        self._anc = f32(_dyn.ancestor_matrix(m))
        self._dof_body = long(m.dof_body)
        self._ipos = f32(m.body_ipos)
        self._gravity = f32(self.sim_params.gravity)
        self._qpos0 = f32(m.qpos0)
        self._zero_qd = torch.zeros(1, m.nv, device=dev)
        self.franka_mass = f32(np.where(np.arange(m.nbody) < self.plug_ref.body0, np.asarray(m.body_mass), 0.0))
        self.keypoint_offsets = algo.keypoint_offsets(self.num_keypoints, self.keypoint_scale, device=dev)
        pts, self.socket_grid, self.plug_grid = self._algo_geometry()
        self.sample_pts = f32(pts)
        self.socket_grid = self.socket_grid._replace(values=self.socket_grid.values.to(dev),
                                                     origin=self.socket_grid.origin.to(dev))
        self.plug_grid = self.plug_grid._replace(values=self.plug_grid.values.to(dev),
                                                 origin=self.plug_grid.origin.to(dev))
        # the engagement geometry (GearsInsert: the gear's origin below the
        # base's shaft top, no base offset)
        self.engage_top = f32([0.0, 0.0, SOCKET_HEIGHT])
        self.engage_base_height = self.socket_base_height
        self.down_quat = f32([1.0, 0.0, 0.0, 0.0])  # randomize.fingertip_centered_rot_initial [pi, 0, 0]
        self._z = f32([0.0, 0.0, 1.0])
        self._ident = f32([0.0, 0.0, 0.0, 1.0])

    def _algo_geometry(self):
        """(sample points, SAPU's socket grid, the SDF reward's plug grid)."""
        return plug_sample_points(), socket_sdf_grid(), plug_sdf_grid()

    # ---- shared helpers -----------------------------------------------
    def _fingertip(self, kin):
        """The fingertip midpoint's position, the hand's rotation, and the
        midpoint's linear and the hand's angular velocity."""
        h = self.hand_body
        x, qq, v = kin.x[:, h], kin.quat[:, h], kin.v[:, h]
        eef = x + maths.quat_rotate(qq, self.eef_offset.expand_as(x))
        return eef, qq, v[:, 3:] + torch.linalg.cross(v[:, :3], eef, dim=-1), v[:, :3]

    def _plug_state(self, q):
        return q[:, self.pq:self.pq + 3], q[:, self.pq + 3:self.pq + 7]

    def _socket_state(self, q):
        yaw = q[:, self.sq + 3]
        return q[:, self.sq:self.sq + 3], maths.quat_from_angle_axis(yaw, self._z.expand(q.shape[0], 3))

    def _gripper_goal(self, socket_pos, socket_quat):
        off = torch.stack([torch.zeros_like(socket_pos[:, 0]), torch.zeros_like(socket_pos[:, 0]),
                           torch.full_like(socket_pos[:, 0], self.socket_base_height + PLUG_GRASP_OFFSET)], -1)
        return socket_pos + maths.quat_rotate(socket_quat, off)

    def _centers(self, q):
        """(plug centre, plug rotation, socket centre, socket rotation): the
        frames of the keypoints and the engagement checks; for the pegs the
        actors' origins (GearsInsert moves both onto the middle shaft's axis)."""
        plug_pos, plug_quat = self._plug_state(q)
        socket_pos, socket_quat = self._socket_state(q)
        return plug_pos, plug_quat, socket_pos, socket_quat

    def _keypoints(self, q):
        plug_pos, plug_quat, socket_pos, socket_quat = self._centers(q)
        n, k = q.shape[0], self.num_keypoints
        off = self.keypoint_offsets.expand(n, k, 3)
        kp_plug = plug_pos[:, None] + maths.quat_rotate(plug_quat[:, None].expand(n, k, 4), off)
        kp_socket = socket_pos[:, None] + maths.quat_rotate(socket_quat[:, None].expand(n, k, 4), off)
        return kp_plug, kp_socket

    # ---- control -------------------------------------------------------
    def compute_force(self, actions, q, qd, task):
        m, n = self.model, q.shape[0]
        kin = _dyn.forward_kinematics(m, q, qd)
        eef, _, elin, eang = self._fingertip(kin)
        dpos = actions[:, 0:3] * self.pos_action_scale
        rot_act = actions[:, 3:6]
        if self.unidirectional_rot:
            rot_act = torch.cat([rot_act[:, :2], -(rot_act[:, 2:3] + 1.0) * 0.5], -1)
        err = torch.cat([rot_act * self.rot_action_scale, dpos], -1)  # (angular, linear)
        J = controllers.body_jacobian(kin, self._anc, self._dof_body, self.hand_body, eef)[:, :, self.arm]
        tau = controllers.task_space_impedance(J, err, torch.cat([eang, elin], -1), self.task_kp, self.task_kd)
        tau = torch.clamp(tau, -self.effort_limit, self.effort_limit)
        qfrc = q.new_zeros(n, m.nv)
        qfrc[:, self.arm] = tau
        # the Franka's weight taken back at each body's centre of mass
        # (disable_gravity on the robot, industreal_base.py:137)
        com = kin.x + maths.quat_rotate(kin.quat, self._ipos.expand(n, -1, -1))
        f = (-self.franka_mass[:, None] * self._gravity[None, :]).expand(n, -1, -1)
        xfrc = torch.cat([torch.linalg.cross(com, f, dim=-1), f], dim=-1)
        return qfrc, xfrc, q.new_zeros(n, m.nq)  # the fingers' setpoint: closed

    # ---- reset ---------------------------------------------------------
    def _rand01(self, generator, n: int) -> dict:
        """The reset's uniform draws in [0, 1), by DRAWS."""
        u = torch.rand(n, sum(w for _, w in self.DRAWS), generator=generator, device=self.device)
        out, at = {}, 0
        for name, w in self.DRAWS:
            out[name] = u[:, at:at + w] if w > 1 else u[:, at]
            at += w
        return out

    def _curriculum_disp(self, u, max_disp):
        """The downward displacement of the plug from the socket's top
        (reference _reset_plug :652-661)."""
        lo = self.curriculum_height_bound[0]
        return lo + (max_disp - lo) * u

    def _place(self, u, max_disp):
        """(socket position, socket yaw, plug position, finger opening,
        grasp point) from the draws (reference :652-681): xy noise on the
        plug only when it is not partly inserted."""
        socket_xy = self.socket_xy_initial + self.socket_xy_noise * (u["socket_xy"] * 2.0 - 1.0)
        lo, hi = self.socket_z_bounds[0], self.socket_z_bounds[1]
        socket_z = lo + (hi - lo) * u["socket_z"]
        yaw = self.socket_rot_noise * (u["socket_yaw"] * 2 - 1)
        socket_pos = torch.cat([socket_xy, socket_z[:, None]], -1)
        disp = self._curriculum_disp(u["disp"], max_disp)
        plug_pos = socket_pos + socket_pos.new_tensor([0.0, 0.0, SOCKET_HEIGHT]) - self._z * disp[:, None]
        above = plug_pos[:, 2] > socket_pos[:, 2] + SOCKET_HEIGHT
        xy = self.plug_xy_noise * (u["plug_xy"] * 2 - 1)
        plug_pos = torch.cat([plug_pos[:, :2] + torch.where(above[:, None], xy, torch.zeros_like(xy)),
                              plug_pos[:, 2:]], -1)
        grasp = plug_pos + plug_pos.new_tensor([0.0, 0.0, PLUG_GRASP_OFFSET])
        return socket_pos, yaw, plug_pos, PLUG_DIAMETER / 2 - 1e-4, grasp

    def init_from_draws(self, u: dict, max_disp):
        """The reset states (q, qd, task) from the uniform draws `u` (by
        DRAWS, each (n,) or (n, width)) and the per-env max displacement
        (n,): the JAX package's `_sample` on its own draws. The arm reaches
        the grasp pose by 24 damped least-squares IK iterations from its
        initial joints, all envs at once (JAX: a `lax.scan` per env)."""
        n = max_disp.shape[0]
        socket_pos, yaw, plug_pos, fingers, grasp = self._place(u, max_disp)
        q = self._qpos0.repeat(n, 1)
        sq, pq = self.sq, self.pq
        q[:, sq:sq + 3] = socket_pos
        q[:, sq + 3] = yaw
        q[:, pq:pq + 3] = plug_pos
        q[:, pq + 3:pq + 7] = self._ident
        arm_q = self.arm_init.expand(n, 7)
        down = self.down_quat.expand(n, 4)
        zero_qd = self._zero_qd.expand(n, -1)
        for _ in range(24):  # reference move_gripper_to_target_pose :762-790, as one-shot IK
            qq = q.clone()
            qq[:, self.q_idx[:7]] = arm_q
            kin = _dyn.forward_kinematics(self.model, qq, zero_qd)
            eef, eq, _, _ = self._fingertip(kin)
            err = controllers.pose_error(eef, eq, grasp, down)
            J = controllers.body_jacobian(kin, self._anc, self._dof_body, self.hand_body, eef)[:, :, self.arm]
            arm_q = arm_q + controllers.get_delta_dof_pos(err, J, method="dls", lam=0.1)
        q[:, self.q_idx[:7]] = arm_q
        q[:, self.q_idx[7:]] = fingers
        task = {
            "max_disp": max_disp,
            "obs_noise": self.socket_pos_obs_noise * (u["obs_noise"] * 2.0 - 1.0),
            "prev_rew": q.new_zeros(n),
            "success": q.new_zeros(n),
            "engaged": q.new_zeros(n),
        }
        return q, q.new_zeros(n, self.model.nv), task

    def sample_init(self, generator, n):
        return self.init_from_draws(self._rand01(generator, n), torch.full((n,), self.initial_max_disp,
                                                                            device=self.device))

    def resample_init(self, generator, old_task):
        # the curriculum's max displacement persists across resets (SBC)
        return self.init_from_draws(self._rand01(generator, self.num_envs), old_task["max_disp"])

    # ---- observations --------------------------------------------------
    def observe(self, q, qd, kin, sensors, task, actions, progress):
        eef, eq, _, _ = self._fingertip(kin)
        socket_pos, socket_quat = self._socket_state(q)
        noisy_goal = self._gripper_goal(socket_pos + task["obs_noise"], socket_quat)
        return torch.cat([q[:, self.q_idx[:7]], eef, eq, noisy_goal, socket_quat, noisy_goal - eef], -1)

    def observe_state(self, q, qd, kin, sensors, task, actions, progress):
        eef, eq, elin, eang = self._fingertip(kin)
        socket_pos, socket_quat = self._socket_state(q)
        goal = self._gripper_goal(socket_pos, socket_quat)
        noisy_goal = self._gripper_goal(socket_pos + task["obs_noise"], socket_quat)
        plug_pos, plug_quat = self._plug_state(q)
        delta = goal - eef
        return torch.cat([q[:, self.q_idx[:7]], qd[:, self.v_idx[:7]], eef, eq, elin, eang, goal, socket_quat, delta,
                          plug_pos, plug_quat, (noisy_goal - eef) - delta], -1)

    # ---- reward ----------------------------------------------------------
    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        plug_pos, plug_quat = self._plug_state(q)
        socket_pos, socket_quat = self._socket_state(q)
        # the SDF-based dense reward (algo_utils :237-275)
        rew = self.sdf_reward_scale * algo.sdf_reward(self.sample_pts, plug_pos, plug_quat, socket_pos, socket_quat,
                                                      self.plug_grid)
        # SAPU's weight and filter (:158-193, the task's _update_rew_buf :383-409)
        interpen = algo.max_interpen_dist(self.sample_pts, plug_pos, plug_quat, socket_pos, socket_quat,
                                          self.socket_grid)
        low, scale = algo.sapu_reward_scale(interpen, self.interpen_thresh)
        rew = torch.where(low, rew * scale, task["prev_rew"])
        kp_plug, kp_socket = self._keypoints(q)
        plug_c, _, socket_c, socket_cq = self._centers(q)
        socket_top = socket_c + maths.quat_rotate(socket_cq, self.engage_top.expand_as(socket_c))
        engaged = algo.check_plug_engaged(plug_c, socket_top, kp_plug, kp_socket, self.engage_base_height,
                                          self.close_error_thresh)
        # successes of high interpenetration do not count (:432-443)
        inserted = algo.check_plug_inserted(plug_c, socket_c, kp_plug, kp_socket, self.success_height_thresh,
                                            self.close_error_thresh) & low
        last = progress >= self.max_episode_length - 1
        # the engagement bonus and the curriculum's scale at the last step only (:412-427, :446-452)
        eng_scale = algo.engagement_reward_scale(plug_c, socket_c, engaged, self.success_height_thresh)
        rew_last = rew + eng_scale * self.engagement_bonus
        sbc = algo.curriculum_reward_scale(task["max_disp"], self.curriculum_height_bound)
        rew_last = torch.where(rew_last < 0.0, rew_last / sbc, rew_last * sbc)
        rew = torch.where(last, rew_last, rew)
        task = dict(task, prev_rew=rew, success=inserted.float(), engaged=engaged.float())
        return rew, last, task

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        return {"successes": task["success"], "engaged": task["engaged"], "curr_max_disp": task["max_disp"]}

    def population_update(self, task, done, progress):
        """SBC: the shared max displacement stepped from the insertion
        success rate over the envs that end their episode this step
        (reference get_new_max_disp :302-318 on
        extras['insertion_successes'] :432-459); unchanged in a step where
        none ends."""
        last = (progress >= self.max_episode_length - 1).float()
        n_last = torch.sum(last)
        rate = torch.sum(task["success"] * last) / torch.clamp(n_last, min=1.0)
        stepped = algo.new_max_disp(rate, task["max_disp"], self.curriculum_height_bound,
                                    self.curriculum_height_step, self.curriculum_success_thresh,
                                    self.curriculum_failure_thresh)
        return dict(task, max_disp=torch.where(n_last > 0, stepped, task["max_disp"]))

    def true_objective(self, q, qd):
        plug_pos, _ = self._plug_state(q)
        socket_pos, _ = self._socket_state(q)
        return -torch.linalg.vector_norm(plug_pos - socket_pos, dim=-1)

    # ---- comparison states ---------------------------------------------
    def _seat(self, rng, n):
        """(depth below the socket's top, offset from its axis, the top's
        height, the fingers' opening) of `contact_states`: the plug in the
        hole, 0-20 um into its wall past the 0.257 mm clearance, 2-25 mm
        deep, or on the hole's floor, 0-20 um into it, by turns (deeper, the
        light plug leaves the wall at speeds whose float32 rounding alone
        nears qd's tolerance); the fingers 0.1-0.3 mm inside the plug's
        radius (the pads' points lie beside the peg)."""
        kind = np.arange(n) % 2
        depth = np.where(kind == 0, rng.uniform(0.002, 0.025, n), SOCKET_HEIGHT + rng.uniform(0.0, 2e-5, n))
        radial = np.where(kind == 0, 0.000257 + rng.uniform(0.0, 2e-5, n), rng.uniform(0.0, 2e-4, n))
        return depth, radial, SOCKET_HEIGHT, PLUG_DIAMETER / 2 - rng.uniform(1e-4, 3e-4, n)

    def contact_states(self, n: int, seed: int):
        """n states (q, qd) in which the SDF rows act, for holding the kernel
        against its plain version: each env's reset pose at the seat's depth
        (the arm at the grasp pose by the task's own IK) with the plug (the
        gear) placed as `_seat` puts it, its centre off the socket's (the
        shaft's) axis in a random direction and tilted about it by 0-0.1
        degrees about a horizontal axis; the fingers as `_seat` opens them; gentle
        velocities. Drawn with numpy from `seed`."""
        m, rng, dev = self.model, np.random.RandomState(seed), self.device
        depth, radial, top, fingers = self._seat(rng, n)
        u = {name: torch.tensor(rng.uniform(0.0, 1.0, (n, w) if w > 1 else n), dtype=torch.float32, device=dev)
             for name, w in self.DRAWS}
        u["disp"] = torch.ones(n, device=dev)  # the reset's drop is the seat's depth: the grasp pose is above it
        q, _, _ = self.init_from_draws(u, torch.tensor(depth, dtype=torch.float32, device=dev))
        q = q.double().cpu().numpy()
        centre = np.asarray(getattr(self, "_center_off", [0.0, 0.0, 0.0]))
        socket_pos = q[:, self.sq:self.sq + 3]
        yaw = q[:, self.sq + 3]
        for i in range(n):
            away = rng.uniform(0, 2 * np.pi)
            spin = _quat_np(np.array([0.0, 0.0, 1.0]), yaw[i])
            axis = np.array([*rng.normal(size=2), 0.0])
            quat = _qmul_np(_quat_np(axis / np.linalg.norm(axis), np.deg2rad(rng.uniform(0.0, 0.1))), spin)
            off = np.array([radial[i] * np.cos(away), radial[i] * np.sin(away), top - depth[i]])
            q[i, self.pq:self.pq + 3] = socket_pos[i] + _qrot_np(spin, centre + off) - _qrot_np(quat, centre)
            q[i, self.pq + 3:self.pq + 7] = quat
        q[:, self.q_idx.cpu().numpy()[7:]] = fingers[:, None]
        qd = rng.uniform(-0.01, 0.01, (n, m.nv))
        qd[:, self.pv:self.pv + 6] *= 0.1
        return torch.tensor(q, dtype=torch.float32, device=dev), torch.tensor(qd, dtype=torch.float32, device=dev)
