from .svd_init import (  # noqa: F401
    InitResult,
    init_quadric_svd,
    quadric_plane_error,
    tangent_planes,
)
from .svd_incremental import IncrementalQuadricInit  # noqa: F401
