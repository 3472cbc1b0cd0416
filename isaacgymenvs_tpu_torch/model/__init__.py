from .spec import (  # noqa: F401
    FIXED,
    FREE,
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_MESH,
    GEOM_PLANE,
    GEOM_SPHERE,
    HINGE,
    SLIDE,
    Model,
    ModelBuilder,
)
from .mjcf import load_mjcf, parse_mjcf  # noqa: F401
from .urdf import load_urdf, parse_urdf  # noqa: F401
