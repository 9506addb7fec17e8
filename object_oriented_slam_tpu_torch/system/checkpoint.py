"""Checkpoint / resume of the full SLAM state.

The reference has no system-state checkpointing (SURVEY.md section 5) --
only re-loadable text dumps.  Here the complete ``SlamState`` (object
records with observation buffers, trajectory, ground plane) serializes to
one ``.npz`` so a run can resume mid-sequence and continue producing
identical output.
"""
from __future__ import annotations

import numpy as np

from .state import ObjectRecord, SlamState


def save_state(state: SlamState, path: str) -> None:
    blobs = {}
    insts = sorted(state.objects)
    blobs["instances"] = np.array(insts, np.int64)
    blobs["frames_pose_wc"] = (np.stack(state.frames_pose_wc)
                               if state.frames_pose_wc else np.zeros((0, 7)))
    blobs["frames_ts"] = np.array(state.frames_ts, np.float64)
    blobs["ground_plane"] = (state.ground_plane if state.ground_plane
                             is not None else np.zeros(0))
    blobs["ground_state"] = np.array([state.ground_state])
    for i in insts:
        r = state.objects[i]
        p = f"obj{i}_"
        blobs[p + "meta"] = np.array(
            [r.label, int(r.initialized), int(r.init_by_3d)], np.int64)
        blobs[p + "vec10"] = (r.vec10 if r.vec10 is not None
                              else np.zeros(0))
        for name in ["obs2d_pose_cw", "obs2d_pose_wc", "obs2d_bbox",
                     "obs3d_pose_wc", "obs3d_meas", "history"]:
            v = getattr(r, name)
            blobs[p + name] = np.stack(v) if v else np.zeros((0,))
        blobs[p + "obs2d_prob"] = np.array(r.obs2d_prob, np.float64)
        blobs[p + "obs2d_frame"] = np.array(r.obs2d_frame, np.int64)
        blobs[p + "obs3d_prob"] = np.array(r.obs3d_prob, np.float64)
        blobs[p + "obs3d_frame"] = np.array(r.obs3d_frame, np.int64)
    np.savez_compressed(path, **blobs)


def load_state(path: str) -> SlamState:
    z = np.load(path, allow_pickle=False)
    state = SlamState()
    state.frames_pose_wc = list(z["frames_pose_wc"])
    state.frames_ts = list(z["frames_ts"])
    gp = z["ground_plane"]
    state.ground_plane = gp if gp.size else None
    state.ground_state = int(z["ground_state"][0])
    for i in z["instances"]:
        i = int(i)
        p = f"obj{i}_"
        meta = z[p + "meta"]
        r = ObjectRecord(instance=i, label=int(meta[0]),
                         initialized=bool(meta[1]), init_by_3d=bool(meta[2]))
        v10 = z[p + "vec10"]
        r.vec10 = v10 if v10.size else None
        for name in ["obs2d_pose_cw", "obs2d_pose_wc", "obs2d_bbox",
                     "obs3d_pose_wc", "obs3d_meas", "history"]:
            arr = z[p + name]
            setattr(r, name, list(arr) if arr.size else [])
        r.obs2d_prob = list(z[p + "obs2d_prob"])
        r.obs2d_frame = [int(x) for x in z[p + "obs2d_frame"]]
        r.obs3d_prob = list(z[p + "obs3d_prob"])
        r.obs3d_frame = [int(x) for x in z[p + "obs3d_frame"]]
        state.objects[i] = r
    return state
