from .extractor import (ExtractorConfig, extract_local_ellipsoids,  # noqa: F401
                        make_extractor, make_fused_extractor,
                        make_split_extractor)
from .ground_plane import GroundPlaneConfig, estimate_ground_plane, make_plane_estimator  # noqa: F401
