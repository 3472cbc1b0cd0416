"""Device resolution for the port's entry points.

Every entry point takes `device=` and defaults to CUDA. Without a GPU the
call raises unless the caller asks for the CPU explicitly; nothing moves
to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    Raises RuntimeError for a CUDA device when PyTorch sees no GPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
