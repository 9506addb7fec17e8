from .measurement import calibrate_measurement_np  # noqa: F401
