"""Two-tier configuration store.

Re-design of the reference's ``Config`` singleton
(``src/config/Config.h:14-70``, ``src/config/Config.cpp``):
an OpenCV-YAML parameter file overlaid by programmatic values, where
``read_value`` prefers the programmatic layer and ``get`` reads the file
layer (missing keys silently read as 0, matching cv::FileStorage).

Here the store is an explicit object (no global singleton), plus a module
level default instance for the System facade.  The OpenCV ``%YAML:1.0``
header and ``key: value`` flat structure of ``Example/param/TUM3.yaml`` are
parsed without requiring the cv2 FileStorage API.
"""
from __future__ import annotations

import re
from typing import Dict, Optional


# defaults seeded by Config::Init (src/config/Config.cpp:24-33)
_DEFAULTS = {
    "Tracking_MINIMUM_INITIALIZATION_FRAME": 15.0,
    "EllipsoidExtractor_DEPTH_RANGE": 6.0,
}


def _parse_opencv_yaml(path: str) -> Dict[str, float]:
    """Parse a flat OpenCV FileStorage yaml into {key: float|str}."""
    out: Dict[str, float] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("%YAML"):
                continue
            m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+?)\s*$", line)
            if not m:
                continue
            key, val = m.group(1), m.group(2)
            if val.startswith('"') and val.endswith('"'):
                out[key] = val.strip('"')
                continue
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


class Config:
    """File parameters + programmatic overrides (Config.h:20-61)."""

    def __init__(self, param_file: Optional[str] = None):
        self._file: Dict[str, float] = {}
        self._values: Dict[str, float] = dict(_DEFAULTS)
        if param_file is not None:
            self.set_parameter_file(param_file)

    def set_parameter_file(self, path: str) -> None:
        self._file = _parse_opencv_yaml(path)

    def set_value(self, key: str, value: float) -> None:
        self._values[key] = value

    def get(self, key: str, default: float = 0.0):
        """File-layer read; missing keys -> 0 like cv::FileStorage."""
        return self._file.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, float(default))
        try:
            return int(round(float(v)))
        except (TypeError, ValueError):
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key, default)
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    def read_value(self, key: str, default: float = 0.0) -> float:
        """Programmatic layer first, then file layer (Config.h:49-61)."""
        if key in self._values:
            return float(self._values[key])
        return self.get_float(key, default)
