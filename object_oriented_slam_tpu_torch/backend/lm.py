"""Mapping-mode LM types (port of the types in ``backend/lm.py``).

In mapping mode the camera poses are fixed (the reference's
``Optimizer.cpp:126,136``), so the object graph decomposes into one
independent 9-DoF problem per object landmark; ``backend/lm_soa.py``
solves all of them as one batch.  The array-of-structs solver of the JAX
package is not ported yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device


class ObjectObservations(NamedTuple):
    """Fixed-capacity per-object observation buffers (padded + masked).

    Shapes (O objects, M2 2d-observations, M3 3d-observations):
      est0      [O, 10]  initial ellipsoid estimates (vec10)
      obj_mask  [O]      which object slots are live
      pose2d_cw [O, M2, 7] camera Tcw per 2d obs
      bbox2d    [O, M2, 4] measured bbox (border coords = -1)
      prob2d    [O, M2]
      mask2d    [O, M2]
      pose3d_wc [O, M3, 7] camera Twc per 3d obs
      meas3d    [O, M3, 10] measured local ellipsoid (vec10)
      prob3d    [O, M3]
      mask3d    [O, M3]
    Float fields are float32, masks are bool.
    """
    est0: torch.Tensor
    obj_mask: torch.Tensor
    pose2d_cw: torch.Tensor
    bbox2d: torch.Tensor
    prob2d: torch.Tensor
    mask2d: torch.Tensor
    pose3d_wc: torch.Tensor
    meas3d: torch.Tensor
    prob3d: torch.Tensor
    mask3d: torch.Tensor


_MASKS = ("obj_mask", "mask2d", "mask3d")


def observations_from_numpy(arrays: Dict[str, np.ndarray],
                            device=None) -> ObjectObservations:
    """Build the port's ObjectObservations from numpy arrays on ``device``
    (the card unless the caller names one; it raises without one).

    ``arrays`` maps every field name of ``ObjectObservations`` (the JAX
    package's field names and shapes) to a numpy array, e.g.
    ``{k: np.asarray(v) for k, v in jax_obs._asdict().items()}``.
    """
    device = resolve_device(device)
    missing = set(ObjectObservations._fields) - set(arrays)
    if missing:
        raise KeyError(f"missing observation fields: {sorted(missing)}")
    out = {}
    for name in ObjectObservations._fields:
        a = np.asarray(arrays[name], bool if name in _MASKS else np.float32)
        out[name] = torch.tensor(a, device=device)
    return ObjectObservations(**out)


def observations_from_flat(flat: torch.Tensor, est_prev: torch.Tensor,
                           layout) -> ObjectObservations:
    """Views into one packed f32 batch on the device (the tracker's
    ``_lm_layout``: ((name, offset, shape), ...)), the slots with
    ``useprev`` warm-started from ``est_prev``, the previous LM call's
    device estimate (JAX ``Tracking._get_unpack`` / ``_lm_from_flat``)."""
    out = {}
    for name, off, shp in layout:
        out[name] = flat[off:off + int(np.prod(shp))].reshape(shp)
    est0 = torch.where(out["useprev"][:, None] > 0.5, est_prev, out["est0"])
    return ObjectObservations(
        est0=est0, obj_mask=out["objmask"] > 0.5,
        pose2d_cw=out["p2"], bbox2d=out["b2"], prob2d=out["pr2"],
        mask2d=out["m2"] > 0.5,
        pose3d_wc=out["p3"], meas3d=out["me3"], prob3d=out["pr3"],
        mask3d=out["m3"] > 0.5)


class LMConfig(NamedTuple):
    scale_3d: float = 10000.0        # Optimizer.Edges.3DEllipsoid.Scale
    gravity_scale: float = 100.0     # Optimizer.Edges.GravityPrior.Scale
    gravity_on: bool = True          # Optimizer.Edges.GravityPrior.Open
    iters: int = 10                  # Optimizer.cpp:291
    min_2d_obs: int = 3              # "> 2 observations" gate (:201)
    huber_delta: float = 0.0         # >0 enables the Huber kernel the
                                     # reference keeps disabled
                                     # (Optimizer.cpp:224)
    check_visibility: bool = False   # the optional 2D-edge visibility
                                     # gate, disabled by default like
                                     # Optimizer.cpp:232 ('c1')
    vis_rows: int = 480              # image size for the in-image test
    vis_cols: int = 640              # (Optimizer.cpp:20-27)
