"""Bounding-box measurement calibration (host side).

Re-implementation of ``calibrateMeasurement`` (the reference's
``src/utils/dataprocess_utils.cpp:150-190``): marks bbox edges within
``border`` pixels of the image border as invalid (-1) and rejects boxes
smaller than ``size_limit`` pixels.  The batched device version of the
JAX package belongs to the depth frontend and is not ported yet.
"""
from __future__ import annotations

import numpy as np


def calibrate_measurement_np(measure: np.ndarray, rows: int, cols: int,
                             border: int, size_limit: int):
    """Returns (calibrated_bbox, is_border). bbox coords invalidated to -1."""
    x_len = measure[2] - measure[0]
    y_len = measure[3] - measure[1]
    if x_len < size_limit or y_len < size_limit:
        return np.full(4, -1.0), True

    out = np.full(4, -1.0)
    correct = 0
    if border < measure[0] < cols - 1 - border:
        out[0] = measure[0]; correct += 1
    if border < measure[2] < cols - 1 - border:
        out[2] = measure[2]; correct += 1
    if border < measure[1] < rows - 1 - border:
        out[1] = measure[1]; correct += 1
    if border < measure[3] < rows - 1 - border:
        out[3] = measure[3]; correct += 1
    return out, correct != 4
