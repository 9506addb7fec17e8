"""Output writers, format-compatible with the reference's text dumps.

  * ``objects.txt``: one row per object, ``instance vec10`` (instanceID,
    x y z qx qy qz qw a b c) -- src/core/System.cpp:75-91.
  * ``object_history.txt``: header count, then per-instance blocks of
    ``obs_count valid vec9`` rows -- src/core/Tracking.cpp:855-896.
  * ``object_list.txt``: ``instance \\t vec9 \\t label`` per optimizer run --
    src/core/Optimizer.cpp:308-316.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def save_objects(path: str, instances: List[int], vec10s: np.ndarray) -> None:
    with open(path, "w") as f:
        for inst, v in zip(instances, vec10s):
            row = " ".join(f"{x:.10g}" for x in v)
            f.write(f"{inst} {row}\n")


def load_objects(path: str):
    instances, vecs = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 11:
                continue
            instances.append(int(float(parts[0])))
            vecs.append([float(x) for x in parts[1:]])
    return instances, np.array(vecs, np.float64).reshape(-1, 10)


def save_object_history(path: str, history: Dict[int, np.ndarray]) -> None:
    """history: instance -> [H, 11] rows (obs_count, valid, vec9)."""
    with open(path, "w") as f:
        f.write(f"{len(history)}\n")
        for inst, mat in history.items():
            f.write(f"{inst} {mat.shape[0]}\n")
            for row in mat:
                f.write(" ".join(f"{x:.10g}" for x in row) + "\n")


def save_object_list(path: str, instances: List[int], vec9s: np.ndarray,
                     labels: List[int]) -> None:
    with open(path, "w") as f:
        for inst, v, lab in zip(instances, vec9s, labels):
            row = " ".join(f"{x:.10g}" for x in v)
            f.write(f"{inst}\t{row}\t{lab}\n")


def save_bbox_with_association(dir_path: str, state) -> None:
    """Per-timestamp bbox files with associated instance ids
    (Tracking::outputBboxMatWithAssociation, Tracking.cpp:30-70)."""
    import os
    os.makedirs(dir_path, exist_ok=True)
    by_ts = {}
    for inst, rec in state.objects.items():
        for fb, bbox, prob in zip(rec.obs2d_frame, rec.obs2d_bbox,
                                  rec.obs2d_prob):
            ts = state.frames_ts[fb]
            by_ts.setdefault(ts, []).append(
                (bbox, rec.label, prob, inst))
    for ts, rows in by_ts.items():
        path = os.path.join(dir_path, f"{ts:.6f}.txt")
        with open(path, "w") as f:
            for n, (bbox, label, prob, inst) in enumerate(rows):
                bb = " ".join(f"{v:.10g}" for v in bbox)
                f.write(f"{n} {bb} {label} {prob:.10g} {inst}\n")


def save_observation_log(path: str, state) -> None:
    """Debug dump of per-instance observations
    (outputObjectObservations, Tracking.cpp:9-28)."""
    with open(path, "w") as f:
        f.write(" --------- ObjectObservations : \n")
        for inst in sorted(state.objects):
            rec = state.objects[inst]
            f.write(f" ---- Instance {inst} ({len(rec.obs2d_bbox)}) :\n")
            for fb, bbox, prob in zip(rec.obs2d_frame, rec.obs2d_bbox,
                                      rec.obs2d_prob):
                bb = " ".join(f"{v:.10g}" for v in bbox)
                f.write(f" -- ob : {fb} | {bb} | {rec.label} | {prob}\n")
            f.write("\n")
