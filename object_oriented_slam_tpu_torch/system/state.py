"""Host-side SLAM state: fixed-capacity observation buffers + map.

The reference keeps pointer graphs (``Map`` of ellipsoid*, per-instance
``Observations`` vectors, ``Frame*`` lists -- src/core/Map.cpp,
Tracking.h:100-135).  Here the state is flat numpy arrays with validity
masks, appended on the host and shipped to the device as one padded batch
per frame, so the jitted backend compiles exactly once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ObjectRecord:
    instance: int
    label: int = -1
    vec10: Optional[np.ndarray] = None      # current map estimate
    initialized: bool = False
    init_by_3d: bool = False
    # 2D observations (Tracking.cpp mmObjectObservations)
    obs2d_pose_cw: List[np.ndarray] = dataclasses.field(default_factory=list)
    obs2d_bbox: List[np.ndarray] = dataclasses.field(default_factory=list)
    obs2d_pose_wc: List[np.ndarray] = dataclasses.field(default_factory=list)
    obs2d_prob: List[float] = dataclasses.field(default_factory=list)
    obs2d_frame: List[int] = dataclasses.field(default_factory=list)
    # 3D observations (Tracking.cpp mmObjectObservations3D)
    obs3d_pose_wc: List[np.ndarray] = dataclasses.field(default_factory=list)
    obs3d_meas: List[np.ndarray] = dataclasses.field(default_factory=list)
    obs3d_prob: List[float] = dataclasses.field(default_factory=list)
    obs3d_frame: List[int] = dataclasses.field(default_factory=list)
    # history rows (obs_count, valid, vec9) for object_history.txt
    history: List[np.ndarray] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SlamState:
    objects: Dict[int, ObjectRecord] = dataclasses.field(default_factory=dict)
    frames_pose_wc: List[np.ndarray] = dataclasses.field(default_factory=list)
    frames_ts: List[float] = dataclasses.field(default_factory=list)
    ground_plane: Optional[np.ndarray] = None  # world-frame vec4
    ground_state: int = 0  # 0 closed / 1 estimating / 2 done (Tracking.h:128)
    # named point-cloud lists for visualization (Map::AddPointCloudList /
    # DeletePointCloudList, src/core/Map.cpp:131-199); values are
    # (points [N,3], colors [N,3] or None)
    cloud_lists: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    # visual-only (non-optimized) ellipsoids (Map::addEllipsoidVisual,
    # src/core/Map.cpp:112-129)
    visual_ellipsoids: List[np.ndarray] = dataclasses.field(
        default_factory=list)

    def record(self, instance: int) -> ObjectRecord:
        if instance not in self.objects:
            self.objects[instance] = ObjectRecord(instance=instance)
        return self.objects[instance]

    def initialized_instances(self) -> List[int]:
        return [i for i, r in self.objects.items() if r.initialized]

    def add_point_cloud_list(self, name: str, pts, colors=None,
                             mode: int = 0) -> None:
        """mode 0 = replace, mode 1 = append (Map.cpp:131-168)."""
        if mode == 1 and name in self.cloud_lists:
            old_p, old_c = self.cloud_lists[name]
            pts = np.concatenate([old_p, np.asarray(pts)])
            if colors is not None and old_c is not None:
                colors = np.concatenate([old_c, np.asarray(colors)])
            else:
                colors = None
        self.cloud_lists[name] = (np.asarray(pts),
                                  None if colors is None
                                  else np.asarray(colors))

    def delete_point_cloud_list(self, name: str, partial: bool = False) -> int:
        """Full or partial-prefix name delete (Map.cpp:170-199)."""
        if not partial:
            return 1 if self.cloud_lists.pop(name, None) is not None else 0
        victims = [k for k in self.cloud_lists if k.startswith(name)]
        for k in victims:
            del self.cloud_lists[k]
        return len(victims)
