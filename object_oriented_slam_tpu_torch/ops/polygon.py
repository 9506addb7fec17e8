"""Convex polygon intersection and ellipsoid 3D IoU.

Port of ``object_oriented_slam_tpu/ops/polygon.py``, which replaces the
vendored ``src/Polygon/Polygon.cpp`` (Sutherland-Hodgman clipping, fixed
64-point storage) and the axis-aligned ellipsoid IoU of
``src/core/Ellipsoid.cpp:346-466`` (XY footprint intersection x Z overlap).

Plain PyTorch on any device, the JAX module's fixed-capacity form:
polygons are [N, 2] vertex arrays with a vertex count; clipping one convex
polygon against each edge of another runs as a loop over the edges with
masked vertices (the reference rasterizes at 1 mm resolution through
OpenCV integer points; here the clip is exact).  It serves the map metric
(``system/metrics.object_map_iou``), off the per-frame path.
"""
from __future__ import annotations

import torch

from ..core import se3

MAX_VERTS = 16


def _clip_against_edge(verts, count, a, b):
    """Clip polygon (verts [M, 2], count) by the half-plane left of the
    edge a -> b."""
    M = verts.shape[0]
    idx = torch.arange(M, device=verts.device)
    valid = idx < count
    nxt = torch.where(idx + 1 >= count, 0, idx + 1)

    e = b - a

    def side(p):
        return e[0] * (p[..., 1] - a[1]) - e[1] * (p[..., 0] - a[0])

    cur = verts
    nxt_v = verts[nxt]
    s_cur = side(cur)
    s_nxt = side(nxt_v)
    # CCW polygons: interior is to the left of each directed edge
    inside_cur = s_cur >= 0.0
    inside_nxt = s_nxt >= 0.0

    denom = s_cur - s_nxt
    t = s_cur / torch.where(denom.abs() > 1e-12, denom, 1e-12)
    inter = cur + t[:, None] * (nxt_v - cur)

    # each input edge emits up to 2 vertices
    emit_cur = inside_cur & valid
    emit_int = (inside_cur != inside_nxt) & valid

    out_v = torch.stack([cur, inter], dim=1).reshape(2 * M, 2)
    out_m = torch.stack([emit_cur, emit_int], dim=1).reshape(2 * M)

    # compact emitted vertices to the front
    order = torch.sort((~out_m).to(torch.int8), stable=True).indices
    out_v = out_v[order][:M]
    new_count = torch.clamp_max(out_m.sum(), M)
    return out_v, new_count


def intersect_convex(poly_a, count_a, poly_b, count_b):
    """Intersection polygon of two convex CCW polygons (fixed capacity):
    (vertices [M, 2], count)."""
    verts, count = poly_a, torch.as_tensor(count_a)
    count_b = torch.as_tensor(count_b)
    for i in range(poly_b.shape[0]):
        a = poly_b[i]
        b = poly_b[torch.where(i + 1 >= count_b, 0, i + 1)]
        nv, nc = _clip_against_edge(verts, count, a, b)
        use = i < count_b
        verts = torch.where(use, nv, verts)
        count = torch.where(use, nc, count)
    return verts, count


def polygon_area(verts, count):
    """Shoelace area of the first ``count`` CCW vertices."""
    M = verts.shape[0]
    idx = torch.arange(M, device=verts.device)
    valid = idx < count
    nxt = torch.where(idx + 1 >= count, 0, idx + 1)
    x, y = verts[:, 0], verts[:, 1]
    cross = x * y[nxt] - x[nxt] * y
    return 0.5 * torch.where(valid, cross, 0.0).sum().abs()


def _rect_poly(hx, hy):
    """CCW rectangle centered at the origin, padded to MAX_VERTS."""
    v = torch.zeros((MAX_VERTS, 2), dtype=hx.dtype, device=hx.device)
    v[0] = torch.stack([hx, -hy])
    v[1] = torch.stack([hx, hy])
    v[2] = torch.stack([-hx, hy])
    v[3] = torch.stack([-hx, -hy])
    return v, torch.tensor(4, device=hx.device)


def ellipsoid_iou_3d(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Axis-aligned-cube IoU of two ellipsoids [10] (Ellipsoid.cpp:346-466).

    Like the reference: e2 is expressed in e1's body frame; footprints are
    the xy rectangles (e1 axis-aligned, e2 rotated by the relative yaw),
    intersection area x z-overlap over the union of cube volumes.
    Returns IoU (the reference returns 1 - IoU as "MIoU error").
    """
    rel = se3.se3_mul(se3.se3_inv(e1[:7]), e2[:7])
    yaw = se3.quat_to_euler_zyx(rel[3:])[2]

    a1, b1, c1 = e1[7].abs(), e1[8].abs(), e1[9].abs()
    a2, b2, c2 = e2[7].abs(), e2[8].abs(), e2[9].abs()

    p1, n1 = _rect_poly(a1, b1)

    # rotated rectangle of e2 at its relative xy offset
    cz, sz = torch.cos(yaw), torch.sin(yaw)
    Rz = torch.stack([torch.stack([cz, -sz]), torch.stack([sz, cz])])
    base = torch.tensor([[1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0]],
                        dtype=e2.dtype, device=e2.device)
    corners = (base * torch.stack([a2, b2])) @ Rz.T + rel[:2]
    p2 = torch.zeros((MAX_VERTS, 2), dtype=e2.dtype, device=e2.device)
    p2[:4] = corners

    inter_v, inter_n = intersect_convex(p1, n1, p2, 4)
    inter_area = polygon_area(inter_v, inter_n)

    # z overlap (Ellipsoid.cpp:351-372)
    z2 = rel[2]
    lo = torch.maximum(-c1, z2 - c2)
    hi = torch.minimum(c1, z2 + c2)
    z_len = (hi - lo).clamp_min(0.0)

    vol_inter = inter_area * z_len
    vol1 = 8.0 * a1 * b1 * c1
    vol2 = 8.0 * a2 * b2 * c2
    return vol_inter / (vol1 + vol2 - vol_inter).clamp_min(1e-12)
