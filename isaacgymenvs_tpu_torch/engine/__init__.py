from .dynamics import (  # noqa: F401
    Kin,
    SimParams,
    SimState,
    bias_force,
    forward_dynamics,
    forward_kinematics,
    integrate_positions,
    mass_matrix,
)
from .contacts import (  # noqa: F401
    ConstraintData,
    constraint_data,
    contact_data,
    solve_contacts,
)
from .step import StepOut, physics_step  # noqa: F401
from .fused import FusedOut, fused_supported, physics_step_fused  # noqa: F401
