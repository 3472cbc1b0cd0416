"""Helpers the Factory tasks share (copied from the JAX package's
isaacgymenvs_tpu/tasks/factory_nut_bolt.py `_stratified_pick` and
`_strip_points`): Insertion (tasks/factory_templates.py) and the nut-bolt
family (tasks/factory_nut_bolt.py) use both."""
from __future__ import annotations

import numpy as np


def _stratified_pick(pts: np.ndarray, n_z: int, n_ang: int) -> np.ndarray:
    """Pick <= n_z * n_ang points stratified over (z, polar angle) bins:
    per bin, the middle one of its points in index order."""
    z = pts[:, 2]
    ang = np.arctan2(pts[:, 1], pts[:, 0])
    zi = np.clip(((z - z.min()) / max(float(np.ptp(z)), 1e-9) * n_z).astype(int), 0, n_z - 1)
    ai = np.clip(((ang + np.pi) / (2 * np.pi) * n_ang).astype(int), 0, n_ang - 1)
    out = []
    for b in range(n_z * n_ang):
        sel = np.where(zi * n_ang + ai == b)[0]
        if len(sel):
            out.append(pts[sel[len(sel) // 2]])
    return np.asarray(out, np.float32)


def _strip_points(model, bodies):
    """Remove the candidate points generated from the geoms of `bodies`."""
    keep = [c for c in range(model.ncp) if model.cpoint_body[c] not in bodies]
    karr = np.asarray(keep, np.int64)
    remap = {c: i for i, c in enumerate(keep)}
    return model.replace(
        cpoint_body=tuple(model.cpoint_body[c] for c in keep),
        cpoint_pos=model.cpoint_pos[karr],
        cpoint_radius=model.cpoint_radius[karr],
        cpoint_friction=model.cpoint_friction[karr],
        ppair_point=tuple(remap[c] for c in model.ppair_point),
        spair_point=tuple(remap[c] for c in model.spair_point),
    )
