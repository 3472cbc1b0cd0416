"""IndustRealTaskGearsInsert (port of
isaacgymenvs_tpu/tasks/industreal_gears_insert.py), batched over envs: put
the gripped medium gear onto the middle shaft of its base, with PegsInsert's
SAPU, SDF reward and SBC.

The meshes share one assembly frame: the base's plate spans x in [-0.075,
0.075] with its shafts at x = -0.03, +0.02 and +0.05, and the medium gear
sits assembled over the middle one (its axis at x = +0.02). Keypoints and
the engagement checks hang off the centre frames (the actor's origin plus
[0.02, 0, 0] rotated by its quaternion); the SDF lookups keep the actors'
origins, the frames the grids were voxelized in. The base stands on
PegsInsert's three slides and yaw hinge, at zero yaw.

The gear's contact sets: 50 bore points against a fine grid cropped to the
middle shaft (`bounds=`: 0.16 mm voxels for the bore's 0.25 mm fit), 12 hub
and 12 rim points of its bottom face against the whole base's grid (the
plate's top), and both fingers' 5 x 4 pad points against the gear's grid:
three grids, two of them on the base's yaw body. With every point also a
table-plane row, the cfg caps the active set at 64 of 228 rows. As in the
JAX package, the small and large gears are not simulated (the reference
resets them to the assembled pose and never moves them).

The meshes are stand-ins written by
assets/industreal/make_industreal_meshes.py.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import maths
from ..model.spec import FREE, GEOM_CYLINDER, ModelBuilder
from ..sdf.builder import add_contact_points, attach_sdf, load_obj, mesh_to_sdf, pair_points_with_sdf
from ..utils.assets import asset_path
from .factory_nut_bolt import FINGER_LENGTH, FINGERPAD_LENGTH
from .industreal_pegs_insert import IndustRealTaskPegsInsert, build_socket, franka_for_industreal

# The gear's own pad points: denser than the pegs' (the pads squeeze its
# teeth, and few points apply a net tilt that wedges the inserted gear).
# Not the nut-bolt family's PAD_POINTS_DENSE of the same name.
_PAD_Z = FINGER_LENGTH - FINGERPAD_LENGTH * np.linspace(0.06, 1.0, 5)
PAD_POINTS_DENSE = np.array([[sx, 0.0, z] for z in _PAD_Z for sx in (-0.008, -0.003, 0.003, 0.008)], np.float32)

# industreal_asset_info_gears.yaml
BASE_HEIGHT = 0.005
SHAFT_HEIGHT = 0.020
GEAR_HEIGHT = 0.025  # mesh z in [0.005, 0.025]
GEAR_BOTTOM_Z = 0.005
GEAR_DENSITY = 1000.0
GRASP_OFFSET = 0.017
GEAR_CENTER = np.array([0.02, 0.0, 0.0], np.float32)  # the medium shaft's axis
GEAR_OUTER_R = 0.021

_MESH = "industreal/mesh/industreal_gears"


@lru_cache(maxsize=None)
def _mesh(name):
    return load_obj(asset_path(f"{_MESH}/industreal_gear_{name}.obj"))


@lru_cache(maxsize=None)
def base_sdf_grid(resolution: int = 256):
    """The whole base's grid: the plate's top under the hub and rim points."""
    return mesh_to_sdf(*_mesh("base"), resolution=resolution, padding=0.05)


@lru_cache(maxsize=None)
def shaft_sdf_grid(resolution: int = 192):
    """A fine grid cropped to the medium shaft (0.16 mm voxels for the
    bore's fit of 0-0.5 mm, which the whole base's 0.65 mm voxels cannot
    resolve); distances are still to the whole base mesh. SAPU's target
    as well."""
    lo = GEAR_CENTER + np.array([-0.015, -0.015, 0.003])
    hi = GEAR_CENTER + np.array([0.015, 0.015, 0.032])
    return mesh_to_sdf(*_mesh("base"), resolution=resolution, bounds=(lo, hi))


@lru_cache(maxsize=None)
def gear_sdf_grid(resolution: int = 160):
    return mesh_to_sdf(*_mesh("medium"), resolution=resolution, padding=0.12)


def _pick_center_frame(pts: np.ndarray, n_z: int, n_ang: int) -> np.ndarray:
    """A stratified (height, angle about the gear's axis) vertex pick: per
    bin, the middle one of its vertices in index order."""
    rel = pts - GEAR_CENTER
    z = pts[:, 2]
    ang = np.arctan2(rel[:, 1], rel[:, 0])
    zi = np.clip(((z - z.min()) / max(float(np.ptp(z)), 1e-9) * n_z).astype(int), 0, n_z - 1)
    ai = np.clip(((ang + np.pi) / (2 * np.pi) * n_ang).astype(int), 0, n_ang - 1)
    out = []
    for b in range(n_z * n_ang):
        sel = np.where(zi * n_ang + ai == b)[0]
        if len(sel):
            out.append(pts[sel[len(sel) // 2]])
    return np.asarray(out, np.float32)


@lru_cache(maxsize=None)
def gear_sample_points():
    """The sample of SAPU and the SDF reward."""
    v, _ = _mesh("medium")
    return _pick_center_frame(v.astype(np.float32), n_z=10, n_ang=20)


@lru_cache(maxsize=None)
def gear_contact_points():
    """(bore, bottom): the bore wall's points (within 1.5 mm of its radius),
    for the shaft's fine grid, and the bottom face's hub and rim points, for
    the base's grid (the rim keeps a tilted gear's teeth above the plate)."""
    v, _ = _mesh("medium")
    v = v.astype(np.float32)
    r = np.hypot(v[:, 0] - GEAR_CENTER[0], v[:, 1])
    bore = v[r < r.min() + 0.0015]
    bottom = v[(v[:, 2] < GEAR_BOTTOM_Z + 0.002) & (r < 0.013)]
    rim = v[(v[:, 2] < GEAR_BOTTOM_Z + 0.002) & (r > GEAR_OUTER_R - 0.003)]
    return (_pick_center_frame(bore, n_z=5, n_ang=10),
            np.concatenate([_pick_center_frame(bottom, n_z=1, n_ang=12), _pick_center_frame(rim, n_z=1, n_ang=12)]))


def build_gear():
    """The medium gear, a free body; its contacts are the SDF-paired points,
    so the cylinder geom only sets mass and inertia (the annulus as a solid
    cylinder about the gear's axis, 30 % void)."""
    b = ModelBuilder()
    r, h = GEAR_OUTER_R, GEAR_HEIGHT - GEAR_BOTTOM_Z
    m = np.pi * r * r * h * GEAR_DENSITY * 0.7
    izz = 0.5 * m * r * r
    ixx = m / 12.0 * (3 * r * r + h * h)
    ipos = GEAR_CENTER + np.array([0.0, 0.0, GEAR_BOTTOM_Z + h / 2])
    body = b.add_body(parent=-1, name="gear", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FREE, mass=m,
                      ipos=tuple(ipos), inertia=np.diag([ixx, ixx, izz]))
    b.qpos0_free[body] = (np.array([0.5, 0.0, SHAFT_HEIGHT], np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(body, GEOM_CYLINDER, tuple(ipos), (0, 0, 0, 1), (r, h / 2, 0.0), friction=1.0)
    return b.finalize()


class IndustRealTaskGearsInsert(IndustRealTaskPegsInsert):
    """Gear onto shaft: PegsInsert's flow with the gear and base assets, the
    centre frames, and the gears task's engagement geometry (the gear's
    origin below the base's shaft top, task :433-437)."""

    # the JAX package's five keys of its `_sample`: no socket yaw
    DRAWS = (("socket_xy", 2), ("socket_z", 1), ("disp", 1), ("plug_xy", 2), ("obs_noise", 3))

    def __init__(self, cfg, device="cuda"):
        env = cfg.setdefault("env", {})
        off = env.get("gear_medium_pos_offset", [-0.05, -0.02, 0.03])
        self._center_off = [-float(off[1]), 0.0, 0.0]  # reference: centre = pos - [offset[1], 0, 0] (task :166)
        # the gears cfg's names for the pegs task's knobs
        env.setdefault("socket_pos_obs_noise", env.get("base_pos_obs_noise", [0.001, 0.001, 0.0]))
        r = cfg.setdefault("randomize", {})
        r.setdefault("socket_pos_xy_initial", r.get("base_pos_xy_initial", [0.5, 0.0]))
        r.setdefault("socket_pos_xy_noise", r.get("base_pos_xy_noise", [0.1, 0.1]))
        r.setdefault("socket_pos_z_noise_bounds", r.get("base_pos_z_noise_bounds", [0.0, 0.05]))
        r.setdefault("socket_rot_noise", [0.0, 0.0, 0.0])  # the base's rotation is the identity
        r.setdefault("plug_pos_xy_noise", (r.get("gear_pos_xyz_noise") or [0.01, 0.01, 0.0])[:2])
        super().__init__(cfg, device)

    # ---- model ---------------------------------------------------------
    def _actors(self):
        return [franka_for_industreal(), build_gear(), build_socket()], ["", "gear:", "base:"]

    def _add_contacts(self, model, plug_body, socket_body, lf, rf):
        """The bore's points against the shaft's fine grid, the hub's and the
        rim's against the whole base's (both grids on the base's yaw body),
        the pads against the gear's."""
        bore_pts, bottom_pts = gear_contact_points()
        model, bore_idx = add_contact_points(model, plug_body, bore_pts, friction=0.5)
        model, bot_idx = add_contact_points(model, plug_body, bottom_pts, friction=0.5)
        model, shaft_g = attach_sdf(model, socket_body, shaft_sdf_grid())
        model, base_g = attach_sdf(model, socket_body, base_sdf_grid())
        model = pair_points_with_sdf(model, bore_idx, shaft_g)
        model = pair_points_with_sdf(model, bot_idx, base_g)
        model, lf_idx = add_contact_points(model, lf, PAD_POINTS_DENSE, friction=1.0)
        model, rf_idx = add_contact_points(model, rf, PAD_POINTS_DENSE, friction=1.0)
        model, gear_g = attach_sdf(model, plug_body, gear_sdf_grid())
        return pair_points_with_sdf(model, lf_idx + rf_idx, gear_g)

    def _setup(self):
        super()._setup()
        self.center_off = torch.tensor(self._center_off, dtype=torch.float32, device=self.device)
        # engaged when the gear's origin is below the base's shaft top (task :433)
        self.engage_top = torch.tensor([0.0, 0.0, BASE_HEIGHT + SHAFT_HEIGHT], device=self.device)
        self.engage_base_height = 0.0

    def _algo_geometry(self):
        """SAPU's target is the shaft's fine crop of the base (the
        reference's shaft_files=[base_file], env_gears.py:190): the whole
        base's 0.65 mm voxels would pass the 1 mm threshold by noise alone.
        Sample points outside the crop read (the clamped border value + the
        distance to the grid) >= 0: no false penetration."""
        return gear_sample_points(), shaft_sdf_grid(), gear_sdf_grid()

    # ---- frames ----------------------------------------------------------
    def _centers(self, q):
        plug_pos, plug_quat = self._plug_state(q)
        socket_pos, socket_quat = self._socket_state(q)
        off = self.center_off.expand_as(plug_pos)
        return (plug_pos + maths.quat_rotate(plug_quat, off), plug_quat,
                socket_pos + maths.quat_rotate(socket_quat, off), socket_quat)

    def _gripper_goal(self, socket_pos, socket_quat):
        """The fingertip's goal above the middle shaft, at the base's height
        + the grasp offset (reference gripper_goal_pos_local, task :129-142)."""
        off = self.center_off + socket_pos.new_tensor([0.0, 0.0, BASE_HEIGHT + GRASP_OFFSET])
        return socket_pos + maths.quat_rotate(socket_quat, off.expand_as(socket_pos))

    # ---- reset ---------------------------------------------------------
    def _place(self, u, max_disp):
        """The base at identity yaw (:606); the gear dropped onto the shaft
        by the curriculum's displacement (_reset_medium_gear :661-672), xy
        noise only when it is not partly inserted (:692-702); the fingers
        across the teeth, 0.5 mm in."""
        base_xy = self.socket_xy_initial + self.socket_xy_noise * (u["socket_xy"] * 2.0 - 1.0)
        lo, hi = self.socket_z_bounds[0], self.socket_z_bounds[1]
        base_z = lo + (hi - lo) * u["socket_z"]
        base_pos = torch.cat([base_xy, base_z[:, None]], -1)
        disp = self._curriculum_disp(u["disp"], max_disp)
        gear_pos = base_pos + base_pos.new_tensor([0.0, 0.0, SHAFT_HEIGHT]) - self._z * disp[:, None]
        above = gear_pos[:, 2] > base_pos[:, 2] + BASE_HEIGHT + SHAFT_HEIGHT
        xy = self.plug_xy_noise * (u["plug_xy"] * 2 - 1)
        gear_pos = torch.cat([gear_pos[:, :2] + torch.where(above[:, None], xy, torch.zeros_like(xy)),
                              gear_pos[:, 2:]], -1)
        ident = self._ident.expand(gear_pos.shape[0], 4)
        grasp = (gear_pos + maths.quat_rotate(ident, self.center_off.expand_as(gear_pos))
                 + gear_pos.new_tensor([0.0, 0.0, GRASP_OFFSET]))
        return base_pos, torch.zeros_like(base_z), gear_pos, GEAR_OUTER_R - 5e-4, grasp

    def _seat(self, rng, n):
        """The gear on the shaft, its axis 0.25-0.28 mm off the shaft's (the
        fit at the shaft's corners: the bore reaches up to 30 um into a
        corner): resting on the plate (its bottom 0-20 um in) or 2-12 mm up
        the shaft, by turns; the fingers' pad points 3 mm off their midline
        0-50 um into the teeth's tips (those 8 mm off lie beyond the gear)."""
        kind = np.arange(n) % 2
        depth = np.where(kind == 0, SHAFT_HEIGHT + rng.uniform(0.0, 2e-5, n), rng.uniform(0.008, 0.018, n))
        radial = 0.00025 + rng.uniform(0.0, 3e-5, n)
        reach = np.sqrt(GEAR_OUTER_R ** 2 - 0.003 ** 2)  # the opening at which those points touch the tips
        return depth, radial, SHAFT_HEIGHT, reach - rng.uniform(0.0, 5e-5, n)
