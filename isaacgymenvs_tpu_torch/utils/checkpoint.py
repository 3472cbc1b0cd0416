"""Checkpoint save/restore (port of isaacgymenvs_tpu/utils/checkpoint.py).

One `.pth` file holds a dict of tensors, `state_dict`s and Python scalars:
network parameters, optimizer state, normalizer stats, the learning rate,
env-side task state and the epoch/frame counters. It is written to a
temporary file and moved into place, so a reader never sees a half-written
file. Loading goes through `torch.load(..., weights_only=True)`, which
unpickles tensors and plain containers only: a file that holds a pickled
callable is refused instead of run. Under a process group only rank 0
writes; every rank may read.
"""
from __future__ import annotations

import os
from typing import Any

import torch

from ..parallel import distributed


def save_checkpoint(path: str, tree: Any) -> None:
    """Write `tree` to `path` (on rank 0 only)."""
    if not distributed.is_main_process():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)  # atomic


def load_checkpoint(path: str, device="cpu") -> Any:
    return torch.load(path, map_location=device, weights_only=True)
