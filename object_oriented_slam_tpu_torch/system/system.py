"""System facade (port of ``system/system.py``).

Mirrors the reference API surface (``include/core/System.h:27-52``):
construction from a settings yaml, ``track_with_objects`` per frame and the
output save helpers, on ``device``: the CUDA device by default (a
``RuntimeError`` names it when there is none), the CPU when the caller
passes ``device="cpu"``.  ``extractor`` / ``plane_estimator``
(``frontend.make_extractor`` / ``make_plane_estimator``) turn on the depth
path; they carry their own device and are made for the same one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..io.config import Config
from ..io import writers
from .tracking import Tracking


class System:
    def __init__(self, settings_file: str, use_viewer: bool = False,
                 extractor=None, plane_estimator=None, device=None):
        self.config = Config(settings_file)
        self.tracker = Tracking(self.config, extractor=extractor,
                                plane_estimator=plane_estimator,
                                device=device)
        self.use_viewer = use_viewer

    # System.h:37 / System.cpp:49-53
    def track_with_objects(self, timestamp: float, pose_wc: np.ndarray,
                           det_mat: np.ndarray,
                           depth: Optional[np.ndarray] = None,
                           rgb: Optional[np.ndarray] = None,
                           with_association: bool = True) -> bool:
        return self.tracker.grab_pose_and_objects(
            timestamp, pose_wc, det_mat, depth, rgb, with_association)

    def open_optimization(self):
        self.tracker.open_optimization = True

    def close_optimization(self):
        self.tracker.open_optimization = False

    def open_ground_plane_estimation(self):
        self.tracker.open_ground_plane_estimation()

    def open_distributed_backend(self, mesh=None):
        self.tracker.enable_distributed(mesh)

    # System.cpp:75-91
    def save_objects_to_file(self, path: str):
        self.tracker.sync()
        st = self.tracker.state
        instances = sorted(st.initialized_instances())
        vecs = np.array([st.objects[i].vec10 for i in instances]).reshape(-1, 10)
        writers.save_objects(path, instances, vecs)

    # Tracking.cpp:855-896
    def save_object_history(self, path: str):
        self.tracker.sync()
        st = self.tracker.state
        hist = {i: np.stack(st.objects[i].history)
                for i in sorted(st.objects)
                if st.objects[i].history}
        writers.save_object_history(path, hist)

    @property
    def map_objects(self):
        self.tracker.sync()
        st = self.tracker.state
        return {i: st.objects[i].vec10 for i in st.initialized_instances()}
