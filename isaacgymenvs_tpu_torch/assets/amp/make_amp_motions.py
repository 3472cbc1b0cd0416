"""Writes the motion clips that stand in for the AMP running and cartwheel
captures, motions/amp_humanoid_run.npy and motions/amp_humanoid_cartwheel.npy,
for the skeleton of ../mjcf/amp_humanoid.xml.

The clip is a periodic procedural run: three strides of STRIDE seconds at
FPS frames per second, the hips, knees, ankles, shoulders and elbows swung
on the stride's phase (the legs half a stride apart, each arm against its
leg), the torso counter-rotating, the pelvis leaning forward, swaying a
little about its heading, and carried forward at SPEED m/s. Its height is
set frame by frame so that the lower foot's sole touches the ground, plus a
short flight after each push-off: about 0.85-0.9 m. The middle angle of
every three-joint cluster stays well inside +-pi/2, so its x-y-z angles
come back from the rotation unchanged.

The cartwheel clip (HumanoidAMPHands) is CARTWHEELS turns of CARTWHEEL
seconds each: the body in a star (arms raised out to the sides over the
head, legs spread, knees and elbows a little bent) rolls about its
forward axis, sideways towards -y, like a wheel whose spokes are the
hands and feet. Its height is set frame by frame so that the lowest of the
soles' corners, the hands' and the head's spheres touches the ground, and
it moves sideways by that spoke's length per radian, so the hands reach the
ground in turn in every turn (right, left), then the feet.

The layout is that of a poselib `SkeletonMotion` saved with `np.save`: a
pickled dict with `fps`, `rotation.arr` (T, 15, 4) local rotations (x, y,
z, w; a three-joint cluster's is qx(a) qy(b) qz(c), a knee's or elbow's a
rotation about y, the root's its world rotation), `root_translation.arr`
(T, 3), `global_velocity.arr` and `global_angular_velocity.arr` (T, 15, 3;
world, by central differences over the frames), `is_local`, and
`skeleton_tree` with `node_names`, `parent_indices.arr` and
`local_translation.arr` (each body's offset in its parent's frame, read
from the MJCF). The motion library reads the root's velocities and FKs the
rest from the rotations.

Run from anywhere: `python isaacgymenvs_tpu_torch/assets/amp/make_amp_motions.py`.
The output is deterministic; the committed file is its output.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MJCF = os.path.join(os.path.dirname(HERE), "mjcf", "amp_humanoid.xml")
OUT = os.path.join(HERE, "motions", "amp_humanoid_run.npy")
OUT_CARTWHEEL = os.path.join(HERE, "motions", "amp_humanoid_cartwheel.npy")
FPS = 30
STRIDE = 0.8  # seconds per stride (one step of each leg)
STRIDES = 3
SPEED = 3.0  # m/s forward (+x)
FLIGHT = 0.025  # m of lift after each push-off
CARTWHEEL = 1.5  # seconds per cartwheel
CARTWHEELS = 2
SPOKE = 0.95  # m, the wheel's radius: sideways travel per radian of roll


def skeleton():
    """(names, parents, local translations, foot-box corners per foot body,
    (centre, radius) of the hands' and head's spheres) from the MJCF, in its
    body order."""
    names, parents, offsets, corners, spheres = [], [], [], {}, {}

    def walk(elem, parent):
        idx = len(names)
        names.append(elem.get("name"))
        parents.append(parent)
        offsets.append(np.array(elem.get("pos", "0 0 0").split(), np.float64) if parent >= 0 else np.zeros(3))
        for g in elem.findall("geom"):
            if g.get("type") == "box":
                c = np.array(g.get("pos").split(), np.float64)
                h = np.array(g.get("size").split(), np.float64)
                corners[idx] = np.array([c + h * np.array([sx, sy, sz]) for sx in (-1, 1) for sy in (-1, 1)
                                         for sz in (-1, 1)])
            if g.get("type") == "sphere" and g.get("name") in ("right_hand", "left_hand", "head"):
                spheres[idx] = (np.array(g.get("pos", "0 0 0").split(), np.float64), float(g.get("size")))
        for child in elem.findall("body"):
            walk(child, idx)

    walk(ET.parse(MJCF).getroot().find("worldbody").find("body"), -1)
    return names, np.asarray(parents, np.int64), np.asarray(offsets), corners, spheres


def quat_axis_angle(axis: int, angle):
    q = np.zeros(np.shape(angle) + (4,))
    q[..., axis] = np.sin(0.5 * np.asarray(angle))
    q[..., 3] = np.cos(0.5 * np.asarray(angle))
    return q


def quat_mul(a, b):
    x1, y1, z1, w1 = np.moveaxis(a, -1, 0)
    x2, y2, z2, w2 = np.moveaxis(b, -1, 0)
    return np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def quat_rotate(q, v):
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def xyz(a, b, c):
    """qx(a) qy(b) qz(c): the rotation of a chain of x, y and z hinges."""
    return quat_mul(quat_axis_angle(0, a), quat_mul(quat_axis_angle(1, b), quat_axis_angle(2, c)))


def joint_rotations(phase, names):
    """Local rotations (T, nbody, 4) of every body but the root at the
    stride phases `phase` (radians); the right leg leads, the left lags
    by pi."""
    s = np.sin
    rot = {n: np.tile([0.0, 0.0, 0.0, 1.0], (len(phase), 1)) for n in names}
    rot["torso"] = xyz(0.03 * s(phase), 0.12 + 0.03 * s(2 * phase), 0.12 * s(phase))
    rot["head"] = xyz(0.02 * s(phase), -0.05, -0.08 * s(phase))
    for side, lead, sign in (("right", 0.0, -1.0), ("left", np.pi, 1.0)):
        p = phase + lead
        # a positive hip_y swings the leg back, a positive knee bends it
        rot[f"{side}_thigh"] = xyz(sign * 0.05 + 0.03 * s(p), -0.25 - 0.55 * s(p), -sign * 0.05 * s(p))
        rot[f"{side}_shin"] = quat_axis_angle(1, 0.9 + 0.7 * s(p + 0.8))
        rot[f"{side}_foot"] = xyz(0.03 * s(p), 0.15 * s(p - 0.5), 0.0 * p)
        # each arm swings against its leg, the elbows bent
        rot[f"{side}_upper_arm"] = xyz(sign * 0.15, 0.5 * s(p), 0.1 * s(p))
        rot[f"{side}_lower_arm"] = quat_axis_angle(1, -1.3 + 0.25 * s(p))
    return np.stack([rot[n] for n in names], 1)


def forward(local_rot, root_pos, parents, offsets):
    """World rotations and positions (T, nbody, 4 / 3) of every body."""
    grot, gpos = np.zeros_like(local_rot), np.zeros(local_rot.shape[:2] + (3,))
    for b, p in enumerate(parents):
        if p < 0:
            grot[:, b], gpos[:, b] = local_rot[:, b], root_pos
        else:
            grot[:, b] = quat_mul(grot[:, p], local_rot[:, b])
            gpos[:, b] = gpos[:, p] + quat_rotate(grot[:, p], offsets[b])
    return grot, gpos


def star_rotations(phase, names):
    """Local rotations (T, nbody, 4) of the cartwheel's star at the roll
    phases `phase` (radians): the arms raised about 155 degrees out to the
    sides, the legs spread 30 degrees, swaying a little with the roll."""
    s = np.sin
    rot = {n: np.tile([0.0, 0.0, 0.0, 1.0], (len(phase), 1)) for n in names}
    rot["torso"] = xyz(0.1 * s(phase), 0.05, 0.0 * phase)
    rot["head"] = xyz(0.05 * s(phase), -0.1, 0.0 * phase)
    for side, sign in (("right", -1.0), ("left", 1.0)):
        # a negative right_shoulder_x (positive left) raises the arm out to its side
        rot[f"{side}_upper_arm"] = xyz(sign * (2.7 + 0.05 * s(phase)), -0.1, 0.0 * phase)
        rot[f"{side}_lower_arm"] = quat_axis_angle(1, -0.15 + 0.05 * s(phase))
        rot[f"{side}_thigh"] = xyz(sign * (0.5 + 0.05 * s(phase)), -0.1, 0.0 * phase)
        rot[f"{side}_shin"] = quat_axis_angle(1, 0.2 + 0.05 * s(phase))
        rot[f"{side}_foot"] = xyz(-sign * 0.2, 0.1, 0.0 * phase)
    return np.stack([rot[n] for n in names], 1)


def lowest_point(grot, gpos, corners, spheres):
    """The height (T,) of the lowest sole corner or sphere surface."""
    low = [(gpos[:, b, None] + quat_rotate(grot[:, b, None], c))[..., 2].min(1) for b, c in corners.items()]
    low += [(gpos[:, b] + quat_rotate(grot[:, b], c))[..., 2] - r for b, (c, r) in spheres.items()]
    return np.min(low, 0)


def save_clip(path, local, root, parents, offsets, names) -> None:
    grot, gpos = forward(local, root, parents, offsets)
    vel = np.gradient(gpos, 1.0 / FPS, axis=0)
    dq = np.gradient(grot, 1.0 / FPS, axis=0)
    conj = grot * np.array([-1.0, -1.0, -1.0, 1.0])
    ang = 2.0 * quat_mul(dq, conj)[..., :3]
    arr = lambda a, dt=np.float32: {"arr": np.asarray(a, dt), "context": {"dtype": np.dtype(dt).name}}
    motion = {
        "rotation": arr(local),
        "root_translation": arr(root),
        "global_velocity": arr(vel),
        "global_angular_velocity": arr(ang),
        "skeleton_tree": {"node_names": list(names), "parent_indices": arr(parents, np.int64),
                          "local_translation": arr(offsets)},
        "is_local": True,
        "fps": FPS,
        "__name__": "SkeletonMotion",
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, motion, allow_pickle=True)
    print(f"wrote {path}: {len(root)} frames at {FPS} fps, root height {root[:, 2].min():.3f}-{root[:, 2].max():.3f} m")


def write_cartwheel(names, parents, offsets, corners, spheres) -> None:
    t = np.arange(int(round(CARTWHEELS * CARTWHEEL * FPS)) + 1) / FPS
    roll = 2 * np.pi * t / CARTWHEEL  # about +x: the head goes over towards -y
    local = star_rotations(roll, names)
    local[:, 0] = quat_axis_angle(0, roll)
    root = np.stack([np.zeros_like(t), -SPOKE * roll, np.zeros_like(t)], -1)
    grot, gpos = forward(local, root, parents, offsets)
    root[:, 2] = -lowest_point(grot, gpos, corners, spheres)
    save_clip(OUT_CARTWHEEL, local, root, parents, offsets, names)


def main() -> None:
    names, parents, offsets, corners, spheres = skeleton()
    write_run(names, parents, offsets, corners)
    write_cartwheel(names, parents, offsets, corners, spheres)


def write_run(names, parents, offsets, corners) -> None:
    t = np.arange(int(round(STRIDES * STRIDE * FPS)) + 1) / FPS
    phase = 2 * np.pi * t / STRIDE
    local = joint_rotations(phase, names)
    root_yaw = quat_axis_angle(2, 0.06 * np.sin(phase))
    local[:, 0] = quat_mul(root_yaw, quat_mul(quat_axis_angle(1, 0.05), quat_axis_angle(0, 0.03 * np.sin(phase))))
    root = np.stack([SPEED * t, 0.02 * np.sin(phase), np.zeros_like(t)], -1)
    # lift the root until the lower sole touches the ground, plus the flight
    grot, gpos = forward(local, root, parents, offsets)
    low = np.min([(gpos[:, b, None] + quat_rotate(grot[:, b, None], c))[..., 2].min(1)
                  for b, c in corners.items()], 0)
    root[:, 2] = -low + FLIGHT * np.maximum(0.0, np.sin(2 * phase)) ** 2
    save_clip(OUT, local, root, parents, offsets, names)


if __name__ == "__main__":
    main()
