"""Asset root resolution for the port.

Robot descriptions (MJCF, URDF) are data. Resolution order:
  1. $ISAACGYMENVS_TPU_ASSETS, when it names a directory;
  2. <repo>/assets, when present (the IsaacGymEnvs asset tree);
  3. this package's own assets/ directory, which holds the hand-written
     Ant (assets/mjcf/nv_ant.xml) and Cartpole (assets/urdf/cartpole.urdf).
"""
from __future__ import annotations

import os

_PKG_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
_REPO_ASSETS = os.path.join(os.path.dirname(os.path.dirname(_PKG_ASSETS)), "assets")


def package_asset_root() -> str:
    """The package's bundled asset directory."""
    return _PKG_ASSETS


def asset_root() -> str:
    env = os.environ.get("ISAACGYMENVS_TPU_ASSETS")
    if env and os.path.isdir(env):
        return env
    if os.path.isdir(_REPO_ASSETS):
        return _REPO_ASSETS
    return _PKG_ASSETS


def asset_path(rel: str) -> str:
    return os.path.join(asset_root(), rel)
