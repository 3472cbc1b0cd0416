"""Procedural terrain generation (host-side numpy): the port's own copy of
isaacgymenvs_tpu/utils/terrain_utils.py, kept line for line so that a grid
made from the same seed is bit-identical in both packages.

The terrain families of the reference's curriculum grid (sloped, rough,
stairs, discrete obstacles, stepping stones; reference anymal_terrain.py
Terrain class) as a dense height grid, which the engine's `Terrain` samples
bilinearly (no trimesh).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def random_uniform_terrain(h, amplitude, hs, rng, step=0.05):
    rows, cols = h.shape
    rough = rng.uniform(-amplitude, amplitude, (rows // 2 + 1, cols // 2 + 1))
    rough = np.round(rough / step) * step
    # upsample x2 (nearest) for coarser roughness features
    rough = np.repeat(np.repeat(rough, 2, 0), 2, 1)[:rows, :cols]
    h += rough
    return h


def sloped_terrain(h, slope, hs):
    rows, cols = h.shape
    x = np.arange(rows)[:, None] * hs
    h += slope * x
    return h


def pyramid_sloped_terrain(h, slope, hs):
    rows, cols = h.shape
    cx, cy = rows / 2, cols / 2
    x = np.abs(np.arange(rows)[:, None] - cx)
    y = np.abs(np.arange(cols)[None, :] - cy)
    d = np.maximum(x, y) * hs
    h += slope * (d.max() - d) if slope > 0 else -slope * d
    return h


def stairs_terrain(h, step_width, step_height, hs):
    rows, cols = h.shape
    steps_cells = max(int(step_width / hs), 1)
    idx = np.arange(rows) // steps_cells
    h += (idx * step_height)[:, None]
    return h


def pyramid_stairs_terrain(h, step_width, step_height, hs):
    rows, cols = h.shape
    cx, cy = rows / 2, cols / 2
    x = np.abs(np.arange(rows)[:, None] - cx)
    y = np.abs(np.arange(cols)[None, :] - cy)
    ring = np.maximum(x, y) * hs
    steps = np.floor(ring / max(step_width, 1e-6))
    h += -(steps * step_height)
    return h


def discrete_obstacles_terrain(h, max_height, min_size, max_size, num_rects, hs, rng):
    rows, cols = h.shape
    for _ in range(num_rects):
        w = rng.integers(int(min_size / hs), max(int(max_size / hs), 2))
        l = rng.integers(int(min_size / hs), max(int(max_size / hs), 2))
        r0 = rng.integers(0, max(rows - w, 1))
        c0 = rng.integers(0, max(cols - l, 1))
        h[r0 : r0 + w, c0 : c0 + l] += rng.choice(
            [-max_height, -max_height / 2, max_height / 2, max_height]
        )
    return h


def stepping_stones_terrain(h, stone_size, stone_distance, max_height, hs, rng, depth=-2.0):
    rows, cols = h.shape
    base = np.full((rows, cols), depth)
    size_c = max(int(stone_size / hs), 1)
    pitch = size_c + max(int(stone_distance / hs), 1)
    for r0 in range(0, rows, pitch):
        off = rng.integers(0, pitch)
        for c0 in range(-off, cols, pitch):
            c1 = max(c0, 0)
            hgt = rng.uniform(0, max_height)
            base[r0 : r0 + size_c, c1 : c0 + size_c] = h[r0 : min(r0 + size_c, rows) - 1, min(c1, cols - 1)] + hgt
    return base


class TerrainGrid:
    """levels x types curriculum grid (reference anymal_terrain.py:543-673):
    each patch is one terrain family at difficulty growing with its row."""

    def __init__(
        self,
        num_levels: int = 10,
        num_terrains: int = 20,
        map_length: float = 8.0,
        map_width: float = 8.0,
        horizontal_scale: float = 0.1,
        border_size: float = 8.0,
        proportions: Sequence[float] = (0.1, 0.1, 0.35, 0.25, 0.2),
        seed: int = 0,
        curriculum: bool = True,
    ):
        rng = np.random.default_rng(seed)
        self.env_rows = num_levels
        self.env_cols = num_terrains
        self.env_length = map_length
        self.env_width = map_width
        self.hs = horizontal_scale
        self.border = int(border_size / horizontal_scale)
        lr = int(map_length / horizontal_scale)
        wr = int(map_width / horizontal_scale)
        rows = num_levels * lr + 2 * self.border
        cols = num_terrains * wr + 2 * self.border
        self.height = np.zeros((rows, cols), np.float32)
        props = np.cumsum(np.asarray(proportions) / np.sum(proportions))
        self.env_origins = np.zeros((num_levels, num_terrains, 3), np.float32)

        for i in range(num_levels):
            for j in range(num_terrains):
                difficulty = (i + 1) / num_levels if curriculum else rng.uniform(0.3, 1.0)
                choice = (j + 0.5) / num_terrains
                patch = np.zeros((lr, wr), np.float32)
                slope = 0.4 * difficulty
                step_h = 0.05 + 0.175 * difficulty
                if choice < props[0]:
                    patch = pyramid_sloped_terrain(patch, slope, self.hs)
                elif choice < props[1]:
                    patch = pyramid_sloped_terrain(patch, slope, self.hs)
                    patch = random_uniform_terrain(patch, 0.05 * difficulty + 0.01, self.hs, rng)
                elif choice < props[2]:
                    patch = pyramid_stairs_terrain(patch, 0.31, step_h, self.hs)
                elif choice < props[3]:
                    patch = pyramid_stairs_terrain(patch, 0.31, -step_h, self.hs)
                else:
                    patch = discrete_obstacles_terrain(
                        patch, 0.15 * difficulty + 0.05, 1.0, 2.0, 20, self.hs, rng
                    )
                r0 = self.border + i * lr
                c0 = self.border + j * wr
                self.height[r0 : r0 + lr, c0 : c0 + wr] = patch
                cx = r0 + lr // 2
                cy = c0 + wr // 2
                self.env_origins[i, j] = (
                    (cx) * self.hs,
                    (cy) * self.hs,
                    float(self.height[cx - 1 : cx + 2, cy - 1 : cy + 2].max()),
                )
        # origin convention: grid index (0,0) at world (0,0)
        self.world_origin = np.zeros(2, np.float32)
