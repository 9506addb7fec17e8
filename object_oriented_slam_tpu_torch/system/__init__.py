from .state import ObjectRecord, SlamState  # noqa: F401
from .system import System  # noqa: F401
from .tracking import Tracking  # noqa: F401
from . import checkpoint, dense_builder, metrics, probe, profiling  # noqa: F401
