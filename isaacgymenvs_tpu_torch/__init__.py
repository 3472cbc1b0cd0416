"""PyTorch/CUDA port of isaacgymenvs_tpu.

The JAX package `isaacgymenvs_tpu` stays the reference. This package
follows its module layout, imports nothing of it (nor JAX), and runs its
hot path -- the fused whole physics step -- through a CUDA kernel written
for Hopper (`engine/csrc/fused_step.cu`). Entry points default to
`device="cuda"`; the CPU runs only when asked for, through each kernel's
plain PyTorch version.
"""
from .device import resolve_device  # noqa: F401
