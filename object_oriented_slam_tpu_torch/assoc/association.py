"""Data association of per-frame 3D ellipsoid observations to map instances.

Re-design of the reference's ``src/core/DataAssociation.cpp``:
  * cost = Euclidean distance between world-frame centers (:49-72)
  * greedy row-wise minimum with a 1.0 m gate and column claiming (:90-135)
  * unmatched observations allocate fresh instance IDs (:137-140)

The reference returns column indices into its (sorted) instance map and uses
them directly as instance IDs -- valid there because auto-mode instances are
created densely from a counter.  Here the mapping back to actual instance IDs
is explicit, which is equivalent for dense IDs and correct in general.

The cost matrix build is vectorized (one [N_obs, N_map] distance matrix);
the tiny greedy loop runs on host, mirroring the sequential column-claiming
semantics exactly.

``associate_observations_optimal`` is the upgrade the greedy scheme
admits (SURVEY.md section 7 component 4): a globally optimal gated
assignment via the Jonker-Volgenant-style auction below — the greedy
row order can steal a map object from the observation that actually
sits on it; the optimal matching cannot.  Same gate, same new-instance
semantics; opt-in (``Tracking.DataAssociation.Optimal: 1``) because the
reference's behavior is the default contract.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

GATE_DIS = 1.0  # SETTING_DIS_THRESH, DataAssociation.cpp:94


class InstanceCounter:
    def __init__(self, start: int = 0):
        self.next = start

    def create(self) -> int:
        v = self.next
        self.next += 1
        return v

    def seed(self, start: int) -> None:
        """Resume allocation past already-used ids (checkpoint restore)."""
        self.next = max(self.next, start)


def associate_observations(obs_centers_world: np.ndarray,
                           obs_valid: Sequence[bool],
                           map_instances: Sequence[int],
                           map_centers: np.ndarray,
                           counter: InstanceCounter) -> List[int]:
    """Returns per-observation instance id (or -1 for invalid observations).

    obs_centers_world: [N, 3] world-frame centers of the frame's 3D
    ellipsoid observations; obs_valid: which rows have a valid estimate;
    map_instances/map_centers: current map (sorted by instance id to match
    the reference's std::map iteration order).
    """
    n = len(obs_valid)
    out = [-1] * n
    order = np.argsort(np.asarray(map_instances)) if len(map_instances) else []
    inst_sorted = [map_instances[i] for i in order]
    centers_sorted = (np.asarray(map_centers, np.float64)[order]
                      if len(map_instances) else np.zeros((0, 3)))

    claimed = np.zeros(len(inst_sorted), bool)
    for i in range(n):
        if not obs_valid[i]:
            continue
        if len(inst_sorted) == 0:
            out[i] = counter.create()
            continue
        d = np.linalg.norm(centers_sorted - obs_centers_world[i], axis=1)
        d = np.where(claimed, np.inf, d)
        j = int(np.argmin(d))
        if d[j] < GATE_DIS:
            out[i] = inst_sorted[j]
            claimed[j] = True
        else:
            out[i] = counter.create()
    return out


def _hungarian(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost assignment on an [n, m] matrix (n <= m after padding).

    Classic O(n^2 m) shortest-augmenting-path Hungarian (Jonker-Volgenant
    structure) in plain numpy — per-frame matrices here are at most a few
    dozen rows, so this is host-trivial.  Returns col index per row.
    """
    n, m = cost.shape
    INF = 1e18
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, np.int64)          # p[j] = row matched to col j
    way = np.zeros(m + 1, np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, INF)
        used = np.zeros(m + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = 0
            for j in range(1, m + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(m + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    row_to_col = np.full(n, -1, np.int64)
    for j in range(1, m + 1):
        if p[j]:
            row_to_col[p[j] - 1] = j - 1
    return row_to_col


def associate_observations_optimal(obs_centers_world: np.ndarray,
                                   obs_valid: Sequence[bool],
                                   map_instances: Sequence[int],
                                   map_centers: np.ndarray,
                                   counter: InstanceCounter) -> List[int]:
    """Globally optimal gated assignment (same contract as
    associate_observations).

    Gating is expressed inside the matching: each observation gets a
    private "new instance" column at cost GATE_DIS, so an observation
    takes a map object only when doing so is globally cheaper than
    opening a fresh track — equivalent to the 1.0 m gate, but decided
    jointly over the frame instead of row-by-row.
    """
    n = len(obs_valid)
    out = [-1] * n
    rows = [i for i in range(n) if obs_valid[i]]
    if not rows:
        return out
    order = np.argsort(np.asarray(map_instances)) if len(map_instances) else []
    inst_sorted = [map_instances[i] for i in order]
    if not inst_sorted:
        for i in rows:
            out[i] = counter.create()
        return out
    centers_sorted = np.asarray(map_centers, np.float64)[order]

    r = len(rows)
    k = len(inst_sorted)
    d = np.linalg.norm(obs_centers_world[rows][:, None]
                       - centers_sorted[None, :], axis=2)     # [r, k]
    # augment with one private new-track column per row at the gate cost
    cost = np.full((r, k + r), GATE_DIS, np.float64)
    cost[:, :k] = d
    assign = _hungarian(cost)
    for ridx, i in enumerate(rows):
        j = int(assign[ridx])
        if j < k and d[ridx, j] < GATE_DIS:
            out[i] = inst_sorted[j]
        else:
            out[i] = counter.create()
    return out
