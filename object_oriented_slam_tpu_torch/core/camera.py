"""Camera intrinsics (reference ``camera_intrinsic``, include/core/Geometry.h:27-33)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    scale: float  # depth units per meter (TUM: 5000)
    width: int = 640
    height: int = 480

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], dtype=np.float32)
