"""Bounding-box measurement calibration.

Re-implementation of ``calibrateMeasurement`` (the reference's
``src/utils/dataprocess_utils.cpp:150-190``): marks bbox edges within
``border`` pixels of the image border as invalid (-1) and rejects boxes
smaller than ``size_limit`` pixels.  Both a host (numpy) version and a
batched tensor version (mask-returning, any device).
"""
from __future__ import annotations

import numpy as np
import torch


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


def calibrate_measurement(measure: torch.Tensor, rows: int, cols: int,
                          border: int, size_limit: int):
    """Tensor version; measure [..., 4] -> (calibrated [..., 4],
    is_border [...])."""
    x_len = measure[..., 2] - measure[..., 0]
    y_len = measure[..., 3] - measure[..., 1]
    too_small = (x_len < size_limit) | (y_len < size_limit)
    lo = torch.full((4,), float(border), dtype=torch.float32,
                    device=measure.device)
    hi = torch.tensor([cols - 1 - border, rows - 1 - border,
                       cols - 1 - border, rows - 1 - border],
                      dtype=torch.float32, device=measure.device)
    ok = (measure > lo) & (measure < hi)
    calibrated = torch.where(ok, measure, -1.0)
    calibrated = torch.where(too_small[..., None], -1.0, calibrated)
    is_border = too_small | ~torch.all(ok, dim=-1)
    return calibrated, is_border
