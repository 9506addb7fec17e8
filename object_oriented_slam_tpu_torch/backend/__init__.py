from .lm import (LMConfig, ObjectObservations, observations_from_flat,  # noqa: F401
                 observations_from_numpy, optimize_objects)
from .lm_soa import optimize_objects_soa  # noqa: F401
from . import ba_kernels  # noqa: F401
