from .measurement import calibrate_measurement, calibrate_measurement_np  # noqa: F401
