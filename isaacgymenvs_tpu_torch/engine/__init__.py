from .dynamics import Kin, SimParams, SimState, forward_kinematics  # noqa: F401
from .fused import FusedOut, fused_supported, physics_step_fused  # noqa: F401
