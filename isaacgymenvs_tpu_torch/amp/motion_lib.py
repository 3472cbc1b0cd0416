"""AMP motion library (port of isaacgymenvs_tpu/amp/motion_lib.py).

Loads poselib `SkeletonMotion` .npy clips and serves frame-blended reference
states. Each clip is preprocessed once on the host, in numpy float64 as the
JAX package does: forward kinematics of the skeleton, the dof angles in the
engine's hinge-chain parameterization (x-y-z angles of each three-joint
cluster, the angle about y of a one-joint body), `np.unwrap`, dof
velocities by `np.gradient`, and the key bodies' world positions. The
arrays then live on the library's device, and `get_motion_state` is a
gather, a lerp of positions, dofs and velocities, and a slerp of the root
rotation. Motion ids and times are drawn from a `torch.Generator`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import maths


def _np_quat_mul(a, b):
    x1, y1, z1, w1 = np.moveaxis(a, -1, 0)
    x2, y2, z2, w2 = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def _np_quat_rot(q, v):
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _quat_to_euler_xyz_intrinsic(q):
    """Decompose q = qx(a) qy(b) qz(c), the rotation of a chain of x, y and
    z hinges: b = asin(m02), a = atan2(-m12, m22), c = atan2(-m01, m00)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m00 = 1 - 2 * (y * y + z * z)
    m01 = 2 * (x * y - w * z)
    m02 = 2 * (x * z + w * y)
    m12 = 2 * (y * z - w * x)
    m22 = 1 - 2 * (x * x + y * y)
    b = np.arcsin(np.clip(m02, -1.0, 1.0))
    a = np.arctan2(-m12, m22)
    c = np.arctan2(-m01, m00)
    return np.stack([a, b, c], axis=-1)


def _axis_angle_of(q, axis_idx: int):
    """Angle of a rotation about one axis (x, y or z)."""
    w = np.clip(q[..., 3], -1.0, 1.0)
    return 2.0 * np.arctan2(q[..., axis_idx], np.where(w == 0, 1e-8, w)) * np.sign(np.ones_like(w))


class MotionLib:
    """One or more SkeletonMotion clips, weighted.

    motion_files: (path, weight) pairs. dof_layout: (skeleton body index,
    dofs) in the engine's dof order, three-dof clusters as x-y-z angles.
    key_body_ids: skeleton bodies whose world positions are served. The
    arrays are float32 tensors on `device`.
    """

    def __init__(self, motion_files: Sequence[Tuple[str, float]], dof_layout: Sequence[Tuple[int, int]],
                 key_body_ids: Sequence[int], device):
        self.device = torch.device(device)
        self.dof_layout = list(dof_layout)
        self.num_dofs = sum(n for _, n in dof_layout)
        roots, rots, dofps, dofvs, keyps, rvels, ravels = [], [], [], [], [], [], []
        lengths, weights, fpss = [], [], []
        for path, w in motion_files:
            d = np.load(path, allow_pickle=True).item()
            fps = float(np.asarray(d["fps"]))
            local_rot = np.asarray(d["rotation"]["arr"], np.float64)  # (T, nbody, 4)
            root_trans = np.asarray(d["root_translation"]["arr"], np.float64)
            gvel = np.asarray(d["global_velocity"]["arr"], np.float64)
            gavel = np.asarray(d["global_angular_velocity"]["arr"], np.float64)
            tree = d["skeleton_tree"]
            parents = np.asarray(tree["parent_indices"]["arr"])
            local_t = np.asarray(tree["local_translation"]["arr"], np.float64)
            T, nb = local_rot.shape[:2]

            # world rotations and positions of the skeleton's bodies
            grot = np.zeros_like(local_rot)
            gpos = np.zeros((T, nb, 3))
            for b in range(nb):
                p = parents[b]
                if p < 0:
                    grot[:, b] = local_rot[:, b]
                    gpos[:, b] = root_trans
                else:
                    grot[:, b] = _np_quat_mul(grot[:, p], local_rot[:, b])
                    gpos[:, b] = gpos[:, p] + _np_quat_rot(grot[:, p], local_t[b])

            # dof angles in the engine's parameterization
            dofp = np.zeros((T, self.num_dofs))
            off = 0
            for body, nd in dof_layout:
                q = local_rot[:, body]
                if nd == 3:
                    dofp[:, off:off + 3] = _quat_to_euler_xyz_intrinsic(q)
                else:
                    dofp[:, off] = _axis_angle_of(q, 1)  # the elbows and knees hinge about y
                off += nd
            dofp = np.unwrap(dofp, axis=0)
            dofv = np.gradient(dofp, 1.0 / fps, axis=0)

            roots.append(root_trans)
            rots.append(local_rot[:, 0])
            dofps.append(dofp)
            dofvs.append(dofv)
            keyps.append(gpos[:, list(key_body_ids)])
            rvels.append(gvel[:, 0])
            ravels.append(gavel[:, 0])
            lengths.append(T)
            weights.append(float(w))
            fpss.append(fps)

        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
        self.num_motions = len(lengths)
        self._fps = np.asarray(fpss)
        self._lengths = np.asarray(lengths)
        self._durations = (self._lengths - 1) / self._fps
        w = np.asarray(weights)
        self._weights = f32(w / w.sum())
        # all frames concatenated; each motion's first frame
        self._starts = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)[:-1]]), dtype=torch.int64, device=dev)
        self.root_pos = f32(np.concatenate(roots))
        self.root_rot = f32(np.concatenate(rots))
        self.dof_pos = f32(np.concatenate(dofps))
        self.dof_vel = f32(np.concatenate(dofvs))
        self.key_pos = f32(np.concatenate(keyps))
        self.root_vel = f32(np.concatenate(rvels))
        self.root_ang_vel = f32(np.concatenate(ravels))
        self._fps_t = f32(self._fps)
        self._dur_t = f32(self._durations)
        self._len_t = torch.as_tensor(self._lengths, dtype=torch.int64, device=dev)

    # ---- tensor API --------------------------------------------------
    def sample_motions(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """n motion ids drawn by weight."""
        return torch.multinomial(self._weights, n, replacement=True, generator=generator)

    def sample_time(self, generator: torch.Generator, motion_ids: torch.Tensor) -> torch.Tensor:
        """A uniform time within each motion's duration."""
        u = torch.rand(motion_ids.shape, generator=generator, device=self.device)
        return u * self._dur_t[motion_ids]

    def motion_length(self, motion_ids: torch.Tensor) -> torch.Tensor:
        return self._dur_t[motion_ids]

    def get_motion_state(self, motion_ids: torch.Tensor, times: torch.Tensor):
        """Frame-blended state at `times` (clamped to each motion's duration):
        (root_pos, root_rot, dof_pos, dof_vel, root_vel, root_ang_vel, key_pos)."""
        fps = self._fps_t[motion_ids]
        dur = self._dur_t[motion_ids]
        t = torch.minimum(torch.clamp(times, min=0.0), dur)
        f = t * fps
        f0 = torch.floor(f).to(torch.int64)
        f1 = torch.minimum(f0 + 1, self._len_t[motion_ids] - 1)
        blend = (f - f0)[..., None]
        i0 = self._starts[motion_ids] + f0
        i1 = self._starts[motion_ids] + f1
        lerp = lambda a: (1 - blend) * a[i0] + blend * a[i1]
        root_rot = maths.quat_slerp(self.root_rot[i0], self.root_rot[i1], blend[..., 0])
        key_pos = (1 - blend[..., None]) * self.key_pos[i0] + blend[..., None] * self.key_pos[i1]
        return (lerp(self.root_pos), root_rot, lerp(self.dof_pos), lerp(self.dof_vel), lerp(self.root_vel),
                lerp(self.root_ang_vel), key_pos)
