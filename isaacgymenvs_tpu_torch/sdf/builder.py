"""SDF grids: the voxelizer on the host and trilinear queries in PyTorch.

Port of isaacgymenvs_tpu/sdf/builder.py. A triangle mesh is voxelized once,
on the host, into a dense signed-distance grid by `csrc/sdf.cpp` (the port's
copy of the JAX package's voxelizer), built with g++ into
`isaacgymenvs_tpu_torch/_build/` at first use and loaded with ctypes; every
per-step query is then a batched trilinear lookup (`sdf_query`,
`sdf_gradient`), which `engine/fused.py` `sdf_dyn` runs at each control
step's entry pose. The model side attaches grids to bodies and pairs
candidate points with them, the contact model of the Factory tasks
(vertex-vs-SDF narrowphase).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import NamedTuple

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "sdf.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# the flags of the JAX package's native/sdf/Makefile: the same arithmetic
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib = None


def _build() -> str:
    """Compile the voxelizer unless built; raises by name without g++."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libsdf_{tag}.so")
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the SDF voxelizer (sdf/csrc/sdf.cpp) is built with g++ at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([cxx, *_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({res.returncode}) on sdf/csrc/sdf.cpp:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            i64, dbl = ctypes.c_int64, ctypes.c_double
            lib.mesh_to_sdf.argtypes = [
                ctypes.POINTER(dbl), i64, ctypes.POINTER(ctypes.c_int32), i64,
                dbl, dbl, dbl, dbl, i64, i64, i64, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
            ]
            lib.mesh_to_sdf.restype = None
            _lib = lib
    return _lib


class SdfGrid(NamedTuple):
    values: torch.Tensor  # (nx, ny, nz) signed distance (metres), float32
    origin: torch.Tensor  # (3,) position of voxel (0, 0, 0) in the mesh frame
    spacing: float


def mesh_to_sdf(verts: np.ndarray, tris: np.ndarray, resolution: int = 64, padding: float = 0.1,
                bounds=None) -> SdfGrid:
    """Voxelize a triangle mesh into a signed distance grid (CPU tensors).

    resolution = voxels along the longest box axis; padding = extra border
    as a fraction of the mesh's bounding-box diagonal. bounds=(lo, hi)
    replaces the padded box: distances and signs still come from the whole
    mesh, only the sampled region shrinks."""
    verts = np.ascontiguousarray(verts, np.float64)
    tris = np.ascontiguousarray(tris, np.int32)
    if bounds is not None:
        lo, hi = np.asarray(bounds[0], np.float64), np.asarray(bounds[1], np.float64)
    else:
        lo, hi = verts.min(0), verts.max(0)
        pad = padding * np.linalg.norm(hi - lo)
        lo, hi = lo - pad, hi + pad
    h = float((hi - lo).max() / (resolution - 1))
    dims = np.maximum(np.ceil((hi - lo) / h).astype(np.int64) + 1, 4)
    out = np.empty(int(dims[0] * dims[1] * dims[2]), np.float32)
    _load().mesh_to_sdf(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(verts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tris),
        float(lo[0]), float(lo[1]), float(lo[2]), h,
        int(dims[0]), int(dims[1]), int(dims[2]), 2,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return SdfGrid(
        values=torch.from_numpy(out.reshape(int(dims[0]), int(dims[1]), int(dims[2]))),
        origin=torch.as_tensor(lo, dtype=torch.float32),
        spacing=h,
    )


def sdf_query(grid: SdfGrid, points: torch.Tensor) -> torch.Tensor:
    """Trilinear signed distance at mesh-frame points (..., 3).

    A point outside the grid gets the trilinear value at its clamp into the
    grid plus its distance to that clamp, so far-away queries keep growing
    instead of saturating at the border value."""
    v = grid.values
    nx, ny, nz = v.shape
    g = (points - grid.origin) / grid.spacing
    gx = torch.clamp(g[..., 0], 0.0, nx - 1.001)
    gy = torch.clamp(g[..., 1], 0.0, ny - 1.001)
    gz = torch.clamp(g[..., 2], 0.0, nz - 1.001)
    dout = torch.sqrt((g[..., 0] - gx) ** 2 + (g[..., 1] - gy) ** 2 + (g[..., 2] - gz) ** 2) * grid.spacing
    x0, y0, z0 = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    fx, fy, fz = gx - x0, gy - y0, gz - z0
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    flat = v.reshape(-1)

    def at(dx, dy, dz):
        return flat[((x0 + dx) * ny + (y0 + dy)) * nz + (z0 + dz)]

    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz + dout


def sdf_gradient(grid: SdfGrid, points: torch.Tensor) -> torch.Tensor:
    """Central-difference SDF gradient, normalized (the outward normal)."""
    e = grid.spacing

    def d(axis):
        dv = torch.zeros(points.shape[-1], dtype=points.dtype, device=points.device)
        dv[axis] = e
        return (sdf_query(grid, points + dv) - sdf_query(grid, points - dv)) / (2 * e)

    g = torch.stack([d(0), d(1), d(2)], dim=-1)
    return g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-9)


# ---------------------------------------------------------------------------
# model side: SDF grids and contact points on a finalized Model
# ---------------------------------------------------------------------------


def load_obj(path: str, scale: float = 1.0):
    """Wavefront OBJ -> (verts (V, 3) float64, tris (T, 3) int32); polygons
    are fan-triangulated, only the geometry is read."""
    vs, fs = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    fs.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(vs, np.float64) * scale, np.asarray(fs, np.int32)


def attach_sdf(model, body: int, grid: SdfGrid):
    """Attach a grid rigidly to `body` (grid coordinates = the body's frame).
    Returns (model, sdf index)."""
    idx = len(model.sdf_body)
    return model.replace(
        sdf_body=model.sdf_body + (int(body),),
        sdf_spacing=model.sdf_spacing + (float(grid.spacing),),
        sdf_values=model.sdf_values + (np.asarray(grid.values, np.float32),),
        sdf_origin=model.sdf_origin + (np.asarray(grid.origin, np.float32),),
    ), idx


def add_contact_points(model, body: int, pts: np.ndarray, radius: float = 0.0, friction: float = 1.0):
    """Append candidate contact points (in the body's frame) to a finalized
    Model. Returns (model, point indices)."""
    k = len(pts)
    idx = tuple(range(model.ncp, model.ncp + k))
    return model.replace(
        cpoint_body=model.cpoint_body + (int(body),) * k,
        cpoint_pos=np.concatenate([model.cpoint_pos, np.asarray(pts, np.float32)]).astype(np.float32),
        cpoint_radius=np.concatenate([model.cpoint_radius, np.full(k, float(radius), np.float32)]).astype(np.float32),
        cpoint_friction=np.concatenate(
            [model.cpoint_friction, np.full(k, float(friction), np.float32)]).astype(np.float32),
    ), idx


def pair_points_with_sdf(model, point_indices, sdf_index: int):
    """Declare candidate points as queries against an SDF grid."""
    return model.replace(
        spair_point=model.spair_point + tuple(int(p) for p in point_indices),
        spair_sdf=model.spair_sdf + (int(sdf_index),) * len(point_indices),
    )
