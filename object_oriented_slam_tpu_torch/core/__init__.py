from . import se3, ellipsoid, camera  # noqa: F401
