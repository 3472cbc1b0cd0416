"""HumanoidAMP: style imitation of a motion clip with adversarial motion
priors (port of isaacgymenvs_tpu/tasks/humanoid_amp.py).

Batched over envs, as the port's other tasks: the PD offset and scale of
the 28 scalar dofs (each three-joint cluster over +-pi, each knee and elbow
over 1.4 times its range about its middle), reference-state init from the
motion library (`Random`, `Start`, or `Hybrid`, which keeps the model's
default pose in a share of the resets), the 105-wide frame that is both the
policy observation and one step of the AMP observation (root height, root
rotation as tangent and normal, root velocities and the key bodies'
positions in the heading frame, each cluster as tangent and normal, dof
velocities), a task reward of 1, early termination when a body other than
the feet touches something while some such body is below the termination
height, the AMP window of `numAMPObsSteps` frames (`extras['amp_obs']`,
210 wide for 2), and the demo windows the discriminator learns from
(`fetch_amp_obs_demo`). Actions are PD targets (`use_pd_targets`), which the
joints' stiffness and damping drive in every physics slice.

The random draws (motion ids, times, hybrid coins) come from the
generator; `init_from_draws` and `amp_obs_demo_at` take given draws, so
that a test can hand the port the JAX package's.

The task reads only body positions, which `engine.dynamics.BodyPoses` gives
(the same values as the full forward kinematics, a tree level at a time),
and the frame that `observe` computes is reused by `reward_done` of the same
step: the step's host-issued ops are what bound its time on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import maths
from ..amp.motion_lib import MotionLib
from ..engine import dynamics as _dyn
from ..envcore.vec_task import VecTask
from ..model import load_mjcf
from ..utils.assets import asset_path

KEY_BODY_NAMES = ["right_hand", "left_hand", "right_foot", "left_foot"]
NUM_AMP_OBS_PER_STEP = 105


class HumanoidAMP(VecTask):
    use_pd_targets = True
    uses_kin = False  # the body positions come from `BodyPoses`

    def __init__(self, cfg, device="cuda"):
        env = cfg["env"]
        self.state_init = str(env.get("stateInit", "Random"))
        self.hybrid_init_prob = float(env.get("hybridInitProb", 0.5))
        self.num_amp_obs_steps = int(env.get("numAMPObsSteps", 2))
        self.local_root_obs = bool(env.get("localRootObs", False))
        self.termination_height = float(env.get("terminationHeight", 0.5))
        self.enable_early_termination = bool(env.get("enableEarlyTermination", True))
        self.contact_body_names = list(env.get("contactBodies", ["right_foot", "left_foot"]))
        self.motion_file = str(env.get("motion_file", "amp_humanoid_run.npy"))
        env.setdefault("episodeLength", 300)
        self.num_obs = NUM_AMP_OBS_PER_STEP
        self.num_acts = 28
        super().__init__(cfg, device)
        self._setup()

    def build_model(self):
        # the joints' stiffness and damping in the MJCF are the PD gains
        return load_mjcf(asset_path("mjcf/amp_humanoid.xml")), self.sim_params_from_cfg()

    def _setup(self):
        m, dev = self.model, self.device
        sdofs = self.scalar_dof_indices
        if len(sdofs) != 28:
            raise ValueError(f"the AMP humanoid has {len(sdofs)} scalar dofs, the task needs 28")
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        self.dof_idx = long(sdofs)
        self.dof_q_idx = long([m.q_adr[m.dof_body[d]] for d in sdofs])
        lo = np.asarray(m.dof_limit_lower)[sdofs]
        hi = np.asarray(m.dof_limit_upper)[sdofs]

        # joint clusters: consecutive scalar dofs of one named body (the
        # massless links of its chain carry the suffix '__f<k>')
        clusters = []  # (name, [positions in scalar-dof order])
        for i, d in enumerate(sdofs):
            name = m.body_names[m.dof_body[d]].split("__f")[0]
            if clusters and clusters[-1][0] == name:
                clusters[-1][1].append(i)
            else:
                clusters.append((name, [i]))
        self.dof_offsets = [0]
        for _, ds in clusters:
            self.dof_offsets.append(self.dof_offsets[-1] + len(ds))
        self.cluster_names = [n for n, _ in clusters]

        # PD action offset and scale
        lim_low, lim_high = lo.copy(), hi.copy()
        for j, (_, ds) in enumerate(clusters):
            o = self.dof_offsets[j]
            if len(ds) == 3:
                lim_low[o:o + 3] = -np.pi
                lim_high[o:o + 3] = np.pi
            else:
                mid = 0.5 * (lim_high[o] + lim_low[o])
                scale = 0.7 * (lim_high[o] - lim_low[o])
                lim_low[o] = mid - scale
                lim_high[o] = mid + scale
        self.pd_offset = torch.as_tensor(0.5 * (lim_high + lim_low), dtype=torch.float32, device=dev)
        self.pd_scale = torch.as_tensor(0.5 * (lim_high - lim_low), dtype=torch.float32, device=dev)

        self.key_bodies = long([m.body_names.index(n) for n in KEY_BODY_NAMES])
        noncontact = np.ones(m.nbody, bool)
        noncontact[[m.body_names.index(n) for n in self.contact_body_names]] = False
        noncontact[0] = True
        self.noncontact_mask = torch.as_tensor(noncontact, device=dev)
        self.qpos0 = torch.as_tensor(np.asarray(m.qpos0, np.float32), device=dev)
        self._poses = _dyn.BodyPoses(m, dev)
        self._frame_memo = None  # (q, qd, frame) of the last observe
        # columns of the three-joint clusters' angles, and of the one-joint bodies'
        three = [o for o, e in zip(self.dof_offsets, self.dof_offsets[1:]) if e - o == 3]
        one = [o for o, e in zip(self.dof_offsets, self.dof_offsets[1:]) if e - o == 1]
        self._three_cols = long([[o, o + 1, o + 2] for o in three])
        self._one_cols = long(one)
        # the observation's column of each entry of cat([tan-norms (6 per cluster), angles])
        order, pos = [], {}
        for j, o in enumerate(three):
            pos[o] = list(range(6 * j, 6 * j + 6))
        for j, o in enumerate(one):
            pos[o] = [6 * len(three) + j]
        for o in self.dof_offsets[:-1]:
            order += pos[o]
        self._dof_obs_order = long(order)

        # the motion library: skeleton names -> the model's clusters
        path = asset_path(f"amp/motions/{self.motion_file}")
        node_names = list(np.load(path, allow_pickle=True).item()["skeleton_tree"]["node_names"])
        dof_layout = [(node_names.index(n), len(ds)) for n, ds in clusters]
        key_ids = [node_names.index(n) for n in KEY_BODY_NAMES]
        self.motion_lib = MotionLib([(path, 1.0)], dof_layout, key_ids, device=dev)

    # ---- init / reset (reference-state init) ---------------------------
    def sample_init(self, generator, n):
        ml = self.motion_lib
        mid = ml.sample_motions(generator, n)
        if self.state_init == "Start":
            t = torch.zeros(n, device=self.device)
        else:
            t = ml.sample_time(generator, mid)
        use_ref = None
        if self.state_init == "Hybrid":
            use_ref = torch.rand(n, generator=generator, device=self.device) < self.hybrid_init_prob
        return self.init_from_draws(mid, t, use_ref)

    def init_from_draws(self, mid, t, use_ref=None):
        """Init states at motion `mid`, time `t`; with `use_ref` (Hybrid) the
        envs where it is False take the model's default pose at rest."""
        m, n = self.model, mid.shape[0]
        if use_ref is not None:
            t = torch.where(use_ref, t, torch.zeros_like(t))
        root_pos, root_rot, dof_pos, dof_vel, root_vel, root_ang_vel, _ = self.motion_lib.get_motion_state(mid, t)
        q = self.qpos0.repeat(n, 1)
        q[:, 0:3] = root_pos
        q[:, 3:7] = maths.quat_unit(root_rot)
        q[:, self.dof_q_idx] = dof_pos
        qd = torch.zeros(n, m.nv, device=self.device)
        qd[:, 0:3] = root_vel
        qd[:, 3:6] = root_ang_vel
        qd[:, self.dof_idx] = dof_vel
        if use_ref is not None:
            keep = use_ref[:, None]
            q = torch.where(keep, q, self.qpos0)
            qd = torch.where(keep, qd, torch.zeros_like(qd))
        frame = self._amp_frame(q, qd)
        # a full window: reward_done rolls the current frame into row 0, so
        # after it the window is [current, t-1, ..., t-K+1]
        return q, qd, {"prev_amp": frame[:, None].repeat(1, self.num_amp_obs_steps, 1)}

    def standing_states(self, n: int, seed: int):
        """n states (q, qd) from the motion clip, for holding the kernel
        against its plain version: motion ids and times drawn with numpy
        from `seed`, every joint 0.02 rad inside its limits, the root
        lowered until the lowest contact point is 0-1 mm into the ground,
        the clip's velocities scaled by 0.05 (at full speed the stance foot
        of a running clip leaves the ground within a step in most states)."""
        m, rng, dev = self.model, np.random.RandomState(seed), self.device
        ml = self.motion_lib
        mid = torch.as_tensor(rng.randint(0, ml.num_motions, n), device=dev)
        t = torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32), device=dev) * ml.motion_length(mid)
        q, qd, _ = self.init_from_draws(mid, t)
        qd = 0.05 * qd
        d = self.dof_idx.cpu().numpy()
        lo, hi = (torch.as_tensor(np.asarray(a, np.float32)[d], device=dev)
                  for a in (m.dof_limit_lower, m.dof_limit_upper))
        q[:, self.dof_q_idx] = torch.minimum(torch.maximum(q[:, self.dof_q_idx], lo + 0.02), hi - 0.02)
        q[:, 2] -= self._lowest_point(q) + torch.as_tensor(rng.uniform(0.0, 1e-3, n).astype(np.float32), device=dev)
        return q, qd

    def lying_states(self, n: int, seed: int):
        """n states (q, qd) of the humanoid on its back, at rest, the joints
        within 0.05 rad (one sigma) of zero, pushed 3-5 cm into the ground:
        about half of them have more candidates within the contact margin
        than the top-K cap of 16 (torso, head, pelvis, arms and legs).
        Drawn with numpy from `seed`."""
        m, rng, dev = self.model, np.random.RandomState(seed), self.device
        q = self.qpos0.repeat(n, 1)
        q[:, self.dof_q_idx] = torch.as_tensor(rng.normal(0.0, 0.05, (n, 28)).astype(np.float32), device=dev)
        q[:, 3:7] = maths.quat_from_angle_axis(torch.full((n,), -0.5 * np.pi, device=dev),
                                               torch.tensor([0.0, 1.0, 0.0], device=dev))
        low = self._lowest_point(q)
        q[:, 2] -= low + torch.as_tensor(rng.uniform(0.03, 0.05, n).astype(np.float32), device=dev)
        return q, torch.zeros(n, m.nv, device=dev)

    def _lowest_point(self, q):
        """Height of the lowest contact candidate's surface at q, per env."""
        m, dev = self.model, self.device
        x, quat = self._poses(q)
        cb = torch.as_tensor(np.asarray(m.cpoint_body, np.int64), device=dev)
        pos = torch.as_tensor(np.asarray(m.cpoint_pos, np.float32), device=dev)
        rad = torch.as_tensor(np.asarray(m.cpoint_radius, np.float32), device=dev)
        return (x[:, cb, 2] + maths.quat_rotate(quat[:, cb], pos)[..., 2] - rad).amin(dim=1)

    # ---- control ---------------------------------------------------------
    def compute_force(self, actions, q, qd, task):
        m, n = self.model, actions.shape[0]
        q_target = actions.new_zeros(n, m.nq)
        q_target[:, self.dof_q_idx] = self.pd_offset + self.pd_scale * actions
        return actions.new_zeros(n, m.nv), actions.new_zeros(n, m.nbody, 6), q_target

    # ---- observations (one layout for the policy and the AMP frames) -----
    def _dof_to_obs(self, dof_pos):
        """Each three-joint cluster as the tangent and normal of its rotation
        qx(a) qy(b) qz(c); each one-joint body as its angle; in cluster order."""
        ex, ey, ez = (dof_pos.new_tensor(v) for v in ([1.0, 0, 0], [0.0, 1, 0], [0.0, 0, 1]))
        a = dof_pos[:, self._three_cols]  # (N, clusters, 3)
        quat = maths.quat_mul(maths.quat_from_angle_axis(a[..., 0], ex),
                              maths.quat_mul(maths.quat_from_angle_axis(a[..., 1], ey),
                                             maths.quat_from_angle_axis(a[..., 2], ez)))
        tan_norm = maths.quat_to_tan_norm(quat).reshape(dof_pos.shape[0], -1)
        return torch.cat([tan_norm, dof_pos[:, self._one_cols]], dim=-1)[:, self._dof_obs_order]

    def _amp_frame_parts(self, root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel, key_pos):
        heading_inv = maths.calc_heading_quat_inv(root_rot)
        rot_obs = maths.quat_mul(heading_inv, root_rot) if self.local_root_obs else root_rot
        local_key = maths.quat_rotate(heading_inv[:, None], key_pos - root_pos[:, None])
        return torch.cat([
            root_pos[:, 2:3],
            maths.quat_to_tan_norm(rot_obs),
            maths.quat_rotate(heading_inv, root_vel),
            maths.quat_rotate(heading_inv, root_ang_vel),
            self._dof_to_obs(dof_pos),
            dof_vel,
            local_key.reshape(local_key.shape[0], -1),
        ], dim=-1)

    def _amp_frame(self, q, qd, x=None):
        """The frame of state (q, qd); `x` the body positions, if known."""
        if x is None:
            x = self._poses(q)[0]
        return self._amp_frame_parts(q[:, 0:3], q[:, 3:7], qd[:, 0:3], qd[:, 3:6], q[:, self.dof_q_idx],
                                     qd[:, self.dof_idx], x[:, self.key_bodies])

    def observe(self, q, qd, kin, sensors, task, actions, progress):
        x = self._poses(q)[0]
        frame = self._amp_frame(q, qd, x)
        self._frame_memo = (q, qd, x, frame)
        return frame

    # ---- reward / termination --------------------------------------------
    def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
        reward = torch.ones(q.shape[0], device=q.device)  # style only: the task reward is 1
        memo = self._frame_memo
        if memo is not None and memo[0] is q and memo[1] is qd:  # observe's of this step
            x, frame = memo[2], memo[3]
        else:
            x = self._poses(q)[0]
            frame = self._amp_frame(q, qd, x)
        terminated = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
        if self.enable_early_termination:
            contact_mag = torch.linalg.vector_norm(sensors.body_force, dim=-1)
            bad_contact = torch.any((contact_mag > 0.1) & self.noncontact_mask, dim=1)
            bad_low = torch.any((x[:, :, 2] < self.termination_height) & self.noncontact_mask, dim=1)
            terminated = bad_contact & bad_low & (progress > 1)
        done = terminated | (progress >= self.max_episode_length - 1)
        prev = torch.roll(task["prev_amp"], 1, dims=1)
        prev[:, 0] = frame
        return reward, done, {"prev_amp": prev}

    def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
        """amp_obs = [current frame, earlier frames], from the window that
        reward_done has just rolled."""
        return {"amp_obs": task["prev_amp"].reshape(q.shape[0], -1)}

    # ---- demo windows for the discriminator ------------------------------
    def fetch_amp_obs_demo(self, generator: torch.Generator, num_samples: int) -> torch.Tensor:
        """(num_samples, num_amp_obs) demo windows at motion ids and start
        times drawn from `generator`."""
        mids = self.motion_lib.sample_motions(generator, num_samples)
        return self.amp_obs_demo_at(mids, self.motion_lib.sample_time(generator, mids))

    def amp_obs_demo_at(self, mids, t0):
        """Demo windows at motion `mids` and start times `t0`, each moved to
        where the whole window lies inside the clip."""
        t0 = torch.clamp(t0, min=self.dt * (self.num_amp_obs_steps - 1))
        frames = []
        for s in range(self.num_amp_obs_steps):
            rp, rr, dp, dv, rv, rav, kp = self.motion_lib.get_motion_state(mids, t0 - self.dt * s)
            frames.append(self._amp_frame_parts(rp, rr, rv, rav, dp, dv, kp))
        return torch.cat(frames, dim=-1)

    @property
    def num_amp_obs(self) -> int:
        return self.num_amp_obs_steps * NUM_AMP_OBS_PER_STEP
