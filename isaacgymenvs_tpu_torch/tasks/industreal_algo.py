"""The IndustReal algorithm layer (port of
isaacgymenvs_tpu/tasks/industreal_algo.py): Simulation-Aware Policy Update
(SAPU), the SDF-based reward, the Sampling-Based Curriculum (SBC) and the
engagement and insertion checks of the IndustReal paper.

The reference queries Warp BVH meshes per env in a host loop; the JAX
package recast every query as a trilinear gather in a voxel SDF grid. Here
the same gathers run through `sdf.builder.sdf_query`, the lookup that
`engine.fused.sdf_dyn` uses, batched over envs: the JAX functions take one
env and are vmapped, these take env-leading tensors ((N, 3) positions, (N,
4) quaternions, (N,) scalars). The sample points (P, 3) are shared by all
envs. `new_max_disp` steps the curriculum of the whole population; the task
calls it from the runtime's `population_update` hook.
"""
from __future__ import annotations

import torch

from .. import maths
from ..sdf.builder import SdfGrid, sdf_query


def transform_points(pos, quat, points):
    """Rigid transform of (P, 3) body-frame points to world, per env: (N, P, 3)."""
    n, p = pos.shape[0], points.shape[0]
    return pos[:, None] + maths.quat_rotate(quat[:, None].expand(n, p, 4), points.expand(n, p, 3))


def points_into_frame(pos, quat, points_world):
    """World (N, P, 3) points into each env's frame at (pos, quat)."""
    n, p = points_world.shape[:2]
    return maths.quat_rotate_inverse(quat[:, None].expand(n, p, 4), points_world - pos[:, None])


# ---- SAPU (reference algo_utils.py:98-193) --------------------------------------


def max_interpen_dist(plug_points, plug_pos, plug_quat, socket_pos, socket_quat,
                      socket_grid: SdfGrid) -> torch.Tensor:
    """(N,) largest depth of the plug's sample points inside the socket
    mesh, 0 when none is inside (get_max_interpen_dists :98-155)."""
    world = transform_points(plug_pos, plug_quat, plug_points)
    d = sdf_query(socket_grid, points_into_frame(socket_pos, socket_quat, world))
    return torch.clamp(-torch.amin(d, dim=-1), min=0.0)


def sapu_reward_scale(interpen: torch.Tensor, interpen_thresh: float):
    """(is_low_interpen, scale): scale = 1 - tanh(depth / thresh) for the
    envs of low interpenetration (get_sapu_reward_scale :158-193); the
    others keep their previous reward."""
    return interpen <= interpen_thresh, 1.0 - torch.tanh(interpen / interpen_thresh)


# ---- the SDF-based dense reward (algo_utils.py:200-275) --------------------------


def sdf_reward(plug_points, plug_pos, plug_quat, socket_pos, socket_quat, plug_grid: SdfGrid) -> torch.Tensor:
    """(N,) -log(mean distance of the plug's sample points outside the plug
    placed at its goal pose): the goal pose is the socket's (the assembled
    plug and socket share one origin in the meshes, reference :217-218), so
    the goal's SDF is the plug's own grid queried in the socket's frame.

    Sign note: the reference's pysdf grids are positive inside, so its
    `where(d > 0, 0, d)` keeps the distances outside the goal surface;
    these grids are positive outside, hence max(d, 0). A floor of 1e-9
    bounds the reward at exact alignment (the reference relies on float
    noise to avoid -log(0))."""
    world = transform_points(plug_pos, plug_quat, plug_points)
    d = sdf_query(plug_grid, points_into_frame(socket_pos, socket_quat, world))
    return -torch.log(torch.clamp(torch.mean(torch.clamp(d, min=0.0), dim=-1), min=1e-9))


# ---- SBC (algo_utils.py:282-318) ---------------------------------------------------


def curriculum_reward_scale(curr_max_disp, height_bound) -> torch.Tensor:
    """The reward scale grows as the curriculum hardens
    (get_curriculum_reward_scale :282-299)."""
    return (height_bound[1] - curr_max_disp) / (height_bound[1] - height_bound[0]) + 1.0


def new_max_disp(curr_success, curr_max_disp, height_bound, height_step, success_thresh: float,
                 failure_thresh: float) -> torch.Tensor:
    """The max initial downward displacement stepped from the population's
    success rate (get_new_max_disp :302-318; height_step[0] < 0 is harder,
    height_step[1] > 0 easier)."""
    like = lambda v: torch.as_tensor(v, dtype=curr_max_disp.dtype, device=curr_max_disp.device)
    harder = torch.maximum(curr_max_disp + like(height_step[0]), like(height_bound[0]))
    easier = torch.minimum(curr_max_disp + like(height_step[1]), like(height_bound[1]))
    return torch.where(curr_success > success_thresh, harder,
                       torch.where(curr_success < failure_thresh, easier, curr_max_disp))


# ---- engagement and insertion checks, the bonus (algo_utils.py:327-502) ---------


def keypoint_offsets(num_keypoints: int, scale: float, device=None) -> torch.Tensor:
    """A unit keypoint line centred at 0 along z, scaled (get_keypoint_offsets :333-343)."""
    z = (torch.linspace(0.0, 1.0, num_keypoints, device=device) - 0.5) * scale
    return torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], dim=-1)


def check_close(keypoints_a, keypoints_b, dist_threshold) -> torch.Tensor:
    """(N,) summed keypoint distance below the threshold (check_plug_close_to_socket :346-367)."""
    return torch.sum(torch.linalg.vector_norm(keypoints_b - keypoints_a, dim=-1), dim=-1) < dist_threshold


def check_plug_engaged(plug_pos, socket_top_pos, keypoints_plug, keypoints_socket, socket_base_height: float,
                       close_error_thresh: float) -> torch.Tensor:
    """The plug's base below the socket's top and close (check_plug_engaged_w_socket :370-392)."""
    below = plug_pos[:, 2] + socket_base_height < socket_top_pos[:, 2]
    return below & check_close(keypoints_plug, keypoints_socket, close_error_thresh)


def check_plug_inserted(plug_pos, socket_pos, keypoints_plug, keypoints_socket, success_height_thresh: float,
                        close_error_thresh: float) -> torch.Tensor:
    """Within the success height of assembled and close (check_plug_inserted_in_socket :395-420)."""
    below = plug_pos[:, 2] < socket_pos[:, 2] + success_height_thresh
    return below & check_close(keypoints_plug, keypoints_socket, close_error_thresh)


def engagement_reward_scale(plug_pos, socket_pos, is_engaged, success_height_thresh: float) -> torch.Tensor:
    """0 when disengaged, else inversely proportional to the insertion depth
    still to go (get_engagement_reward_scale :485-502)."""
    scale = 1.0 / ((plug_pos[:, 2] - socket_pos[:, 2] - success_height_thresh) + 0.1)
    return torch.where(is_engaged, scale, torch.zeros_like(scale))
