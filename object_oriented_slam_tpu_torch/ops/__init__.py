from . import linalg  # noqa: F401
