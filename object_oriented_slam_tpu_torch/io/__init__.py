from .config import Config  # noqa: F401
from . import writers  # noqa: F401
