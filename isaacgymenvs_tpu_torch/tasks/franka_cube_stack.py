"""FrankaCubeStack: stack cube A on cube B with operational-space or
joint-torque control (port of isaacgymenvs_tpu/tasks/franka_cube_stack.py),
batched over envs.

The scene composes the Franka (base on its stand at (-0.45, 0, 1.125)), a
fixed 1.2 m x 1.2 m table top at z = 1, and two free cubes of 5 cm (A) and
7 cm (B) into one forest. Contacts are pair rows only: cube A's corners
against the table and against cube B, cube B's against the table, and the
finger corners against cube A (40 rows, the cfg's cap of 20 active).

With `controlType: osc` (19 observations, 7 actions) the first six action
components are a task-space pose increment of the grip site (10 cm in front
of the hand) scaled by (0.1 m, 0.5 rad); each step runs the forward
kinematics, the grip site's Jacobian, the CRBA mass matrix and its inverse,
and operational-space control with a null-space posture term toward the
default pose (`controllers.operational_space_control`), clipped to the
joints' effort limits. With `joint_tor` (26 observations, 8 actions) the
first seven are joint torques as fractions of the effort limits. The last
action component opens (>= 0) or closes the fingers, whose position drives
(stiffness 800, damping 40) take 0.04 or 0 as the setpoint. The staged
reward (distance, lift, alignment, then the stack bonus) and the episode's
end on a stack follow the reference; `successes` reports the stack flag.

The JAX package orders the task-space increment (angular, linear) and
reads the action as (linear, angular): the port keeps both orders.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import controllers, maths
from ..engine import dynamics as _dyn
from ..envcore.vec_task import VecTask
from ..model import load_urdf
from ..model.compose import compose
from ..model.spec import FIXED, FREE, GEOM_BOX, ModelBuilder, box_inertia
from ..utils.assets import asset_path

FRANKA_URDF = "urdf/franka_description/robots/franka_panda.urdf"


def _box_actor(name: str, size, density: float, fixed: bool, pos):
    """A one-body model: a box of full extents `size`, welded at `pos` or
    free with its start position at `pos`."""
    b = ModelBuilder()
    half = np.asarray(size) / 2.0
    mass, inertia = box_inertia(density, half)
    body = b.add_body(parent=-1, name=name, pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FIXED if fixed else FREE,
                      mass=mass, inertia=inertia)
    if fixed:
        b.body_pos[body] = np.asarray(pos, np.float32)
    else:
        b.qpos0_free[body] = (np.asarray(pos, np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(body, GEOM_BOX, (0, 0, 0), (0, 0, 0, 1), half, 1.0)
    return b.finalize()


class FrankaCubeStack(VecTask):
    use_pd_targets = True
    uses_kin = False  # poses from `BodyPoses`; the OSC runs its own forward kinematics

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self.control_type = str(env.get("controlType", "osc"))
        self.action_scale = float(env.get("actionScale", 1.0))
        self.r_dist_scale = float(env.get("distRewardScale", 0.1))
        self.r_lift_scale = float(env.get("liftRewardScale", 1.5))
        self.r_align_scale = float(env.get("alignRewardScale", 2.0))
        self.r_stack_scale = float(env.get("stackRewardScale", 16.0))
        env.setdefault("episodeLength", 300)
        self.num_obs = 19 if self.control_type == "osc" else 26
        self.num_acts = 7 if self.control_type == "osc" else 8
        self.cubeA_size = 0.050
        self.cubeB_size = 0.070
        self.table_height = 1.0 + 0.05 / 2
        super().__init__(cfg, device)

        m, dev = self.model, self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        sdofs = self.scalar_dof_indices  # the 9 Franka dofs
        self.q_idx = long([m.q_adr[m.dof_body[d]] for d in sdofs])
        self.v_idx = long(sdofs)
        self.arm = np.asarray(sdofs[:7])
        self.arm_t = long(self.arm)
        self.default_dof = f32([0.0, 0.1963, 0.0, -2.6180, 0.0, 2.9416, 0.7854, 0.035, 0.035])
        self.dof_lower = f32(np.asarray(m.dof_limit_lower)[sdofs])
        self.dof_upper = f32(np.asarray(m.dof_limit_upper)[sdofs])
        self.effort_limit = f32(np.asarray(m.dof_max_effort)[sdofs][:7])
        self.hand_body = m.body_names.index("panda_hand")
        self.lf_body = m.body_names.index("panda_leftfinger")
        self.rf_body = m.body_names.index("panda_rightfinger")
        self.eef_offset = f32([0.0, 0.0, 0.1])  # grip site in the hand frame
        self.aq = m.q_adr[self.cubeA_ref.body0]
        self.bq = m.q_adr[self.cubeB_ref.body0]
        self.kp = 150.0
        self.kd = 2.0 * np.sqrt(150.0)
        self.kp_null = 10.0
        self.kd_null = 2.0 * np.sqrt(10.0)
        self.cmd_limit = f32([0.1, 0.1, 0.1, 0.5, 0.5, 0.5])
        self._anc = f32(_dyn.ancestor_matrix(m))
        self._dof_mask = f32(_dyn.dof_ancestor_mask(m))
        self._dof_body = long(m.dof_body)
        self._qpos0 = f32(m.qpos0)
        self._eye7 = torch.eye(7, device=dev)
        self._poses = _dyn.BodyPoses(m, dev)
        self._pose_memo = None  # (q, x, quat) of the last observe
        self._up = f32([0.0, 0.0, 1.0])
        self._a_center, self._b_center = f32([0.0, -0.15]), f32([0.0, 0.2])
        self._stack_offset = f32([0.0, 0.0, (self.cubeA_size + self.cubeB_size) / 2])

    def build_model(self):
        franka = load_urdf(asset_path(FRANKA_URDF), fix_base=True)
        stiff = np.zeros(9, np.float32)
        damp = np.zeros(9, np.float32)
        stiff[7:] = 800.0  # the fingers' position drives
        damp[7:] = 40.0
        franka = franka.replace(dof_stiffness=stiff, dof_damping=damp)
        table = _box_actor("table", [1.2, 1.2, 0.05], 1000.0, True, [0, 0, 1.0])
        cubeA = _box_actor("cubeA", [self.cubeA_size] * 3, 555.0, False,
                           [0.0, -0.2, self.table_height + self.cubeA_size / 2])
        cubeB = _box_actor("cubeB", [self.cubeB_size] * 3, 555.0, False,
                           [0.0, 0.2, self.table_height + self.cubeB_size / 2])
        model, refs = compose([franka, table, cubeA, cubeB], ["", "table:", "A:", "B:"])
        self.franka_ref, self.table_ref, self.cubeA_ref, self.cubeB_ref = refs
        # the Franka's base on its stand
        body_pos = np.asarray(model.body_pos).copy()
        body_pos[0] = [-0.45, 0.0, 1.125]
        model = model.replace(body_pos=body_pos)
        # pair rows: cube A's corners against the table top and cube B, cube
        # B's against the table top, the finger corners against cube A
        table_geom, a_geom, b_geom = self.table_ref.geom0, self.cubeA_ref.geom0, self.cubeB_ref.geom0
        a_body, b_body = self.cubeA_ref.body0, self.cubeB_ref.body0
        fingers = {model.body_names.index("panda_leftfinger"), model.body_names.index("panda_rightfinger")}
        ppp, ppg = [], []
        for c in range(model.ncp):
            body = model.cpoint_body[c]
            if body == a_body:
                ppp += [c, c]
                ppg += [table_geom, b_geom]
            elif body == b_body:
                ppp.append(c)
                ppg.append(table_geom)
            elif body in fingers:
                ppp.append(c)
                ppg.append(a_geom)
        model = model.replace(ppair_point=tuple(ppp), ppair_geom=tuple(ppg), plane_contacts=False)
        return model, self.sim_params_from_cfg()

    # ---- init -----------------------------------------------------------
    def sample_init(self, generator, n):
        dev = self.device
        u = lambda *shape: torch.rand(*shape, generator=generator, device=dev)
        # every env starts at the default pose: the reference scales its dof
        # noise by 0 (and places the cubes without startPositionNoise or
        # startRotationNoise)
        q = self._qpos0.repeat(n, 1)
        q[:, self.q_idx] = torch.clamp(self.default_dof, self.dof_lower, self.dof_upper)
        # cube placement: xy about the table centre, a random yaw
        pa = u(n, 2) * 0.3 - 0.15 + self._a_center
        pb = u(n, 2) * 0.2 - 0.1 + self._b_center
        yaw_a = u(n) * 1.57 - 0.785
        yaw_b = u(n) * 1.57 - 0.785
        for qa, p, yaw, size in ((self.aq, pa, yaw_a, self.cubeA_size), (self.bq, pb, yaw_b, self.cubeB_size)):
            q[:, qa:qa + 2] = p
            q[:, qa + 2] = self.table_height + size / 2
            q[:, qa + 3:qa + 7] = maths.quat_from_angle_axis(yaw, self._up.expand(n, 3))
        return q, q.new_zeros(n, self.model.nv), {"stack": torch.zeros(n, dtype=torch.bool, device=dev)}

    # ---- control --------------------------------------------------------
    def _eef(self, x, quat):
        """The grip site: 10 cm in front of the hand."""
        h = self.hand_body
        return x[:, h] + maths.quat_rotate(quat[:, h], self.eef_offset.expand(x.shape[0], 3))

    def osc_torques(self, dpose, q, qd):
        """Arm torques (N, 7) of the operational-space controller for the
        task-space increment `dpose` (N, 6), ordered (linear, angular) as
        the actions are."""
        m = self.model
        kin = _dyn.forward_kinematics(m, q, qd)
        eef = self._eef(kin.x, kin.quat)
        J = controllers.body_jacobian(kin, self._anc, self._dof_body, self.hand_body, eef)[:, :, self.arm_t]
        M = _dyn.mass_matrix(m, kin, (self._anc, self._dof_mask))
        Minv = _dyn.spd_inverse(M[:, self.arm_t][:, :, self.arm_t] + 1e-6 * self._eye7)
        # the grip site's spatial velocity (angular, linear at the site)
        v = kin.v[:, self.hand_body]
        eef_vel = torch.cat([v[:, :3], v[:, 3:] + torch.linalg.cross(v[:, :3], eef, dim=-1)], dim=-1)
        err = torch.cat([dpose[:, 3:6], dpose[:, 0:3]], dim=-1)
        q_err = maths.normalize_angle(self.default_dof[:7] - q[:, self.q_idx[:7]])
        tau = controllers.operational_space_control(
            J, Minv, err, eef_vel, qd[:, self.v_idx[:7]], kp=self.kp, kd=self.kd,
            null_kp=self.kp_null, null_kd=self.kd_null, q_err=q_err)
        return torch.clamp(tau, -self.effort_limit, self.effort_limit)

    def compute_force(self, actions, q, qd, task):
        n, m = q.shape[0], self.model
        if self.control_type == "osc":
            tau = self.osc_torques(actions[:, :6] * self.cmd_limit * self.action_scale, q, qd)
            grip = actions[:, 6]
        else:
            tau = actions[:, :7] * self.effort_limit * self.action_scale
            grip = actions[:, 7]
        qfrc = q.new_zeros(n, m.nv)
        qfrc[:, self.v_idx[:7]] = tau
        q_target = q.new_zeros(n, m.nq)
        q_target[:, self.q_idx[7:]] = torch.where(grip >= 0.0, 0.04, 0.0)[:, None].expand(n, 2)
        return qfrc, q.new_zeros(n, m.nbody, 6), q_target

    # ---- observations ---------------------------------------------------
    def _observed_poses(self, q):
        """Body poses at q (`BodyPoses`), kept for the reward of the same step."""
        x, quat = self._poses(q)
        self._pose_memo = (q, x, quat)
        return x, quat

    def _poses_of(self, q):
        """The poses `observe` took at this very q, else fresh ones."""
        memo = self._pose_memo
        return memo[1:] if memo is not None and memo[0] is q else self._poses(q)

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        x, quat = self._observed_poses(q)
        cubeA_pos = q[:, self.aq:self.aq + 3]
        parts = [q[:, self.aq + 3:self.aq + 7], cubeA_pos, q[:, self.bq:self.bq + 3] - cubeA_pos,
                 self._eef(x, quat), quat[:, self.hand_body]]
        parts.append(q[:, self.q_idx[7:]] if self.control_type == "osc" else q[:, self.q_idx])
        return torch.cat(parts, dim=-1)

    # ---- reward ---------------------------------------------------------
    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        x, quat = self._poses_of(q)
        eef = self._eef(x, quat)
        cubeA_pos = q[:, self.aq:self.aq + 3]
        cubeB_pos = q[:, self.bq:self.bq + 3]
        norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
        d = norm(cubeA_pos - eef)
        d_lf = norm(cubeA_pos - x[:, self.lf_body])
        d_rf = norm(cubeA_pos - x[:, self.rf_body])
        dist_reward = 1.0 - torch.tanh(10.0 * (d + d_lf + d_rf) / 3.0)

        cubeA_height = cubeA_pos[:, 2] - self.table_height
        lifted = (cubeA_height - self.cubeA_size) > 0.04
        lift_reward = lifted.float()
        d_ab = norm(cubeB_pos - cubeA_pos + self._stack_offset)
        align_reward = (1.0 - torch.tanh(10.0 * d_ab)) * lifted
        dist_reward = torch.maximum(dist_reward, align_reward)

        target_height = self.cubeB_size + self.cubeA_size / 2
        aligned = norm((cubeB_pos - cubeA_pos)[:, :2]) < 0.02
        on_top = torch.abs(cubeA_height - target_height) < 0.02
        stack = aligned & on_top & (d > 0.04)
        rewards = torch.where(
            stack, torch.full_like(d, self.r_stack_scale),
            self.r_dist_scale * dist_reward + self.r_lift_scale * lift_reward + self.r_align_scale * align_reward)
        done = stack | (progress >= self.max_episode_length - 1)
        return rewards, done, {"stack": stack}

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        """The stack flag as `successes` (the reference ends the episode on a stack)."""
        return {"successes": task["stack"].float()}

    def true_objective(self, q, qd):
        return q[:, self.aq + 2]

    def contact_states(self, n: int, seed: int, kinds=("table", "stacked", "grasp")):
        """n states (q, qd) in which pair rows act, for holding the kernel
        against its plain version, the kinds in turn: both cubes on the
        table (`table`), cube A on cube B (`stacked`), or cube A between
        the fingers (`grasp`: its faces 0-0.5 mm into the finger pads, the
        finger tips 7 mm past its far face, cube B on the table). A cube on
        a surface has its lowest corner 0-0.5 mm in, is yawed at random and
        tilted by up to 2 degrees (so that no two corners' keys tie); the
        Franka's arm joints lie within 0.05 rad of the default pose; gentle
        velocities. Drawn with numpy from `seed`."""
        m, rng = self.model, np.random.RandomState(seed)
        dev = self.device
        q = np.tile(np.asarray(m.qpos0, np.float64), (n, 1))
        q_idx = self.q_idx.cpu().numpy()
        default = self.default_dof.cpu().numpy().astype(np.float64)
        q[:, q_idx] = default
        q[:, q_idx[:7]] += rng.uniform(-0.05, 0.05, (n, 7))
        kind = [kinds[i % len(kinds)] for i in range(n)]
        grasp = np.asarray([k == "grasp" for k in kind])
        q[grasp, q_idx[7]] = q[grasp, q_idx[8]] = self.cubeA_size / 2 - rng.uniform(0.0, 5e-4, int(grasp.sum()))
        hx, hq = (t.double().cpu().numpy() for t in self._poses(torch.as_tensor(q, dtype=torch.float32, device=dev))) \
            if grasp.any() else (None, None)
        signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])

        def tilted(yaw):
            axis = np.array([*rng.normal(size=2), 0.0])
            tilt = _quat_np(axis / np.linalg.norm(axis), np.deg2rad(rng.uniform(0.0, 2.0)))
            return _qmul_np(_quat_np(np.array([0.0, 0.0, 1.0]), yaw), tilt)

        def on_surface(quat, half, height):
            """The centre height that puts the lowest corner 0-0.5 mm below `height`."""
            low = _qrot_np(quat, signs * half)[:, 2].min()  # the eight corners at once
            return height - low - rng.uniform(0.0, 5e-4)

        ha, hb = self.cubeA_size / 2, self.cubeB_size / 2
        for i in range(n):
            qb = tilted(rng.uniform(-0.785, 0.785))
            pb = np.array([rng.uniform(-0.1, 0.1), 0.2 + rng.uniform(-0.1, 0.1), 0.0])
            pb[2] = on_surface(qb, hb, self.table_height)
            if kind[i] == "table":
                qa = tilted(rng.uniform(-0.785, 0.785))
                pa = np.array([rng.uniform(-0.15, 0.15), -0.15 + rng.uniform(-0.15, 0.15), 0.0])
                pa[2] = on_surface(qa, ha, self.table_height)
            elif kind[i] == "stacked":
                # in B's frame: a small offset and yaw, a tilt, the lowest corner 0-0.5 mm into B's top face
                rel = tilted(rng.uniform(-0.3, 0.3))
                off = np.array([*rng.uniform(-0.004, 0.004, 2), 0.0])
                off[2] = on_surface(rel, ha, hb)
                qa, pa = _qmul_np(qb, rel), pb + _qrot_np(qb, off)
            else:
                # in the hand's frame: centred between the pads, 18 mm from the finger base (at z 0.0584)
                qa = hq[i, self.hand_body]
                pa = hx[i, self.hand_body] + _qrot_np(qa, np.array([0.0, 0.0, 0.0584 + 0.018]))
            q[i, self.aq:self.aq + 3], q[i, self.aq + 3:self.aq + 7] = pa, qa
            q[i, self.bq:self.bq + 3], q[i, self.bq + 3:self.bq + 7] = pb, qb
        qd = rng.uniform(-0.01, 0.01, (n, m.nv))
        return torch.tensor(q, dtype=torch.float32, device=dev), torch.tensor(qd, dtype=torch.float32, device=dev)


def _quat_np(axis, angle):
    return np.array([*(np.sin(angle / 2) * np.asarray(axis)), np.cos(angle / 2)])


def _qmul_np(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def _cross_np(a, b):
    """np.cross over the last axis, by its own formula (a1 b2 - a2 b1, ...):
    the same values without its per-call axis handling."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _qrot_np(q, v):
    """v (3,) or (k, 3) rotated by q (xyzw), row by row."""
    xyz, w = np.asarray(q[:3]), q[3]
    t = 2.0 * _cross_np(xyz, v)
    return v + w * t + _cross_np(xyz, t)
