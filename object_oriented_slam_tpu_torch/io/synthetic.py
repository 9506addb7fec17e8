"""Synthetic multi-object sequences with a known ground truth.

Port of ``object_oriented_slam_tpu/io/synthetic.py``: K ellipsoids
standing on the plane z = 0, an orbiting camera, projected bounding-box
detections and an analytic (ray-traced) depth image per frame.
Everything random is drawn with numpy from a seed.

``make_lm_batch`` builds one seeded mapping-mode LM batch (2D, 3D and
gravity edges with every gate exercised) for checking the BA kernels
against their plain versions at any size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core import ellipsoid as ell
from ..core import se3
from ..core.camera import Camera


@dataclasses.dataclass(frozen=True)
class SyntheticScene:
    """Ground truth: K ellipsoids (vec10, world frame) + plane z=0."""
    ellipsoids: np.ndarray      # [K, 10] (t, q, s)
    labels: np.ndarray          # [K] int
    camera: Camera


def default_camera() -> Camera:
    return Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0,
                  width=640, height=480)


def make_scene(n_objects: int = 12, seed: int = 0,
               camera: Camera | None = None,
               radius_range=(0.4, 1.5),
               scale_range=(0.15, 0.45),
               labels=None) -> SyntheticScene:
    """Objects on a ring inside the camera orbit, resting on z=0."""
    rng = np.random.RandomState(seed)
    if camera is None:
        camera = default_camera()
    ang = np.linspace(0, 2 * np.pi, n_objects, endpoint=False)
    ang += rng.uniform(-0.25, 0.25, n_objects) / max(n_objects, 1)
    r = rng.uniform(*radius_range, n_objects)
    sc = rng.uniform(*scale_range, (n_objects, 3))
    yaw = rng.uniform(0, 2 * np.pi, n_objects)
    vecs = np.zeros((n_objects, 10))
    vecs[:, 0] = r * np.cos(ang)
    vecs[:, 1] = r * np.sin(ang)
    vecs[:, 2] = sc[:, 2]                       # resting on the plane
    vecs[:, 3] = 0.0
    vecs[:, 4] = 0.0
    vecs[:, 5] = np.sin(yaw / 2)                # yaw-only rotation
    vecs[:, 6] = np.cos(yaw / 2)
    vecs[:, 7:] = sc
    if labels is None:
        labels = rng.choice([56, 57, 58, 59, 60, 61, 62, 63], n_objects)
    return SyntheticScene(ellipsoids=vecs, labels=np.asarray(labels, int),
                          camera=camera)


def _look_at(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera pose in world (t, q) looking from cam_pos at target, with the
    x right / y down / z forward camera axes of TUM."""
    look = target - cam_pos
    look = look / np.linalg.norm(look)
    x_cam = np.cross(look, np.array([0.0, 0.0, 1.0]))
    x_cam /= np.linalg.norm(x_cam)
    y_cam = np.cross(look, x_cam)
    R_wc = np.stack([x_cam, y_cam, look], axis=1)
    return np.concatenate([cam_pos, _mat_to_quat_np(R_wc)])


def orbit_trajectory(n_frames: int, radius: float = 3.2,
                     height: float = 1.4, seed: int = 1,
                     jitter: float = 0.0) -> np.ndarray:
    """Camera poses [F, 7] (t, q) orbiting the origin, looking at it."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((n_frames, 7))
    for f in range(n_frames):
        a = 2 * np.pi * f / n_frames
        c = np.array([radius * np.cos(a), radius * np.sin(a), height])
        if jitter:
            c = c + rng.normal(0, jitter, 3)
        poses[f] = _look_at(c, np.zeros(3))
    return poses


def _mat_to_quat_np(m):
    t = np.trace(m)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2
        x = (m[2, 1] - m[1, 2]) / (4 * w)
        y = (m[0, 2] - m[2, 0]) / (4 * w)
        z = (m[1, 0] - m[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
        v = np.zeros(3)
        v[i] = s / 4
        v[j] = (m[j, i] + m[i, j]) / s
        v[k] = (m[k, i] + m[i, k]) / s
        x, y, z = v
        w = (m[k, j] - m[j, k]) / s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# analytic depth rendering
# ---------------------------------------------------------------------------

def render_depth(ellipsoids, pose_wc, cam: Camera, plane_z: float = 0.0,
                 device=None) -> torch.Tensor:
    """Ray-traced uint16-style depth [H, W] int32 (TUM scale) of the scene,
    computed on ``device`` (default: where ``ellipsoids`` lives, the CPU for
    numpy input).

    ellipsoids: [K, 10] world vec10; pose_wc: [7] camera pose in world.
    Each pixel ray o + t d (camera origin o, direction d in world) is
    intersected with every dual quadric in its own frame: with
    p = R_o^T (x - t_o) / s the surface is |p| = 1, a quadratic in t.
    ``t * scale`` is truncated to an integer, so another rounding order
    moves some pixels by one count and silhouette pixels between a hit and
    a miss.
    """
    e = torch.as_tensor(ellipsoids, dtype=torch.float32, device=device)
    pose = torch.as_tensor(pose_wc, dtype=torch.float32, device=e.device)
    H, W = cam.height, cam.width
    u = torch.arange(W, dtype=torch.float32, device=e.device)
    v = torch.arange(H, dtype=torch.float32, device=e.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")            # [H, W]
    d_cam = torch.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                         torch.ones_like(uu)], dim=-1)       # [H, W, 3]
    R_wc = se3.quat_to_mat(pose[3:])
    o = pose[:3]
    d_w = d_cam @ R_wc.T                                     # [H, W, 3]

    # into the (unit-sphere) object frames
    R_o = se3.quat_to_mat(e[:, 3:7])                         # [K, 3, 3]
    s = e[:, 7:]
    om = torch.einsum("kj,kji->ki", o - e[:, :3], R_o) / s   # [K, 3]
    dm = torch.einsum("hwj,kji->khwi", d_w, R_o) / s[:, None, None, :]
    A = (dm * dm).sum(-1)
    B = 2.0 * (dm * om[:, None, None, :]).sum(-1)
    C = ((om * om).sum(-1) - 1.0)[:, None, None]
    disc = B * B - 4 * A * C
    t = (-B - torch.sqrt(disc.clamp_min(0.0))) / (2 * A)
    t_obj = torch.where((disc > 0) & (t > 0.05), t, torch.inf)   # [K, H, W]
    t_min = t_obj.amin(dim=0) if len(e) else torch.full_like(uu, torch.inf)

    # ground plane z = plane_z
    dz = d_w[..., 2]
    t_pl = (plane_z - o[2]) / torch.where(dz.abs() < 1e-9, 1e-9, dz)
    t_pl = torch.where(t_pl > 0.05, t_pl, torch.inf)
    t_all = torch.minimum(t_min, t_pl)

    # t is the distance along d_w whose camera-z component is |d_cam| z=1
    # => camera depth = t (d_cam has unit z), TUM 16-bit scale
    depth = torch.where(torch.isfinite(t_all), t_all * cam.scale, 0.0)
    depth = torch.where(depth < 65535.0, depth, 0.0)
    return depth.to(torch.int32)


def project_bboxes(ellipsoids, pose_wc, cam: Camera):
    """Projected bbox [K, 4] + visibility mask [K] (center in front, in
    image), float32 like the JAX package's version."""
    e = torch.as_tensor(np.asarray(ellipsoids), dtype=torch.float32)
    pose_cw = se3.se3_inv(torch.as_tensor(np.asarray(pose_wc),
                                          dtype=torch.float32))
    K = torch.as_tensor(cam.K)
    bbox = ell.project_bbox(e, pose_cw[None], K)
    c_cam = e[:, :3] @ se3.quat_to_mat(pose_cw[3:]).T + pose_cw[:3]
    vis = ((c_cam[:, 2] > 0.2) & (bbox[:, 0] < cam.width) & (bbox[:, 2] > 0)
           & (bbox[:, 1] < cam.height) & (bbox[:, 3] > 0)
           & torch.all(torch.isfinite(bbox), dim=1))
    hi = torch.tensor([cam.width - 1.0, cam.height - 1.0,
                       cam.width - 1.0, cam.height - 1.0])
    clipped = torch.minimum(torch.maximum(bbox, torch.zeros(4)), hi)
    return clipped, vis


class SyntheticDataset:
    """Drop-in analogue of the TUM dataset reader for generated scenes.

    frames() yields (i, ts, pose_wc7, depth_i32, rgb=None, det_mat[N,8])
    with detection rows ``id x1 y1 x2 y2 label rate instance`` (the
    reference's bbox format) with manual instance = object index.
    ``depth_i32`` is an int32 numpy array [H, W] rendered on
    ``depth_device`` (default CPU), or None with ``with_depth=False`` (the
    2D-only loop never reads it).
    """

    def __init__(self, scene: SyntheticScene, n_frames: int = 60,
                 orbit_radius: float = 3.2, height: float = 1.4,
                 min_bbox_px: float = 12.0, seed: int = 1,
                 with_depth: bool = True, depth_device=None):
        self.with_depth = with_depth
        self.depth_device = depth_device
        self.scene = scene
        self.poses = orbit_trajectory(n_frames, orbit_radius, height,
                                      seed=seed)
        self.min_bbox_px = min_bbox_px
        self.n_frames = n_frames

    def frames(self):
        ell_d = torch.as_tensor(self.scene.ellipsoids, dtype=torch.float32,
                                device=self.depth_device)
        for f in range(self.n_frames):
            pose = self.poses[f]
            depth = None
            if self.with_depth:
                depth = render_depth(ell_d, pose, self.scene.camera
                                     ).cpu().numpy()
            bbs, vis = project_bboxes(self.scene.ellipsoids.astype(np.float32),
                                      pose.astype(np.float32),
                                      self.scene.camera)
            bbs, vis = bbs.numpy(), vis.numpy()
            rows = []
            for k in range(len(bbs)):
                w = bbs[k, 2] - bbs[k, 0]
                h = bbs[k, 3] - bbs[k, 1]
                if not vis[k] or w < self.min_bbox_px or h < self.min_bbox_px:
                    continue
                rows.append([len(rows), *bbs[k], self.scene.labels[k],
                             1.0, k])
            det = np.asarray(rows, np.float64).reshape(-1, 8)
            yield f, float(f) / 30.0, pose, depth, None, det


def make_lm_batch(n_objects: int, m2: int, m3: int, seed: int = 0,
                  camera: Camera | None = None) -> Dict[str, np.ndarray]:
    """One seeded mapping-mode LM batch as numpy arrays (the fields of
    ``backend.lm.ObjectObservations``).

    Object o is seen by up to ``m2`` cameras around it (bbox noise 0.5 px)
    and has up to ``m3`` 3D measurements, each with a random multiple of
    90 deg of yaw so that every branch of the 4-rotation argmin is taken.
    Every gate is exercised: object 1 has 2 live 2D edges (the >2-obs
    gate), the last slot is empty, some fill levels are partial, one bbox
    coordinate per object is border-invalidated (-1) and object 0 has one
    all-NaN bbox (the NaN gate).
    """
    rng = np.random.RandomState(seed)
    cam = camera or default_camera()
    K = torch.as_tensor(cam.K, dtype=torch.float64)
    O = n_objects
    gts = np.zeros((O, 10))
    gts[:, :2] = rng.uniform(-2.0, 2.0, (O, 2))
    gts[:, 7:] = rng.uniform(0.2, 0.5, (O, 3))
    gts[:, 2] = gts[:, 9]
    yaw = rng.uniform(0, 2 * np.pi, O)
    gts[:, 5], gts[:, 6] = np.sin(yaw / 2), np.cos(yaw / 2)

    est0 = np.tile([0, 0, 0, 0, 0, 0, 1, 1, 1, 1.0], (O, 1))
    obj_mask = np.zeros(O, bool)
    p2 = np.tile([0, 0, 0, 0, 0, 0, 1.0], (O, m2, 1))
    b2 = np.full((O, m2, 4), -1.0)
    pr2 = np.zeros((O, m2))
    k2 = np.zeros((O, m2), bool)
    p3 = np.tile([0, 0, 0, 0, 0, 0, 1.0], (O, m3, 1))
    me3 = np.tile([0, 0, 0, 0, 0, 0, 1, 1, 1, 1.0], (O, m3, 1))
    pr3 = np.zeros((O, m3))
    k3 = np.zeros((O, m3), bool)
    for o in range(O - 1 if O > 1 else O):
        gt = gts[o]
        obj_mask[o] = True
        dyaw = rng.normal(0, 0.1)
        est0[o, :3] = gt[:3] + rng.normal(0, 0.08, 3)
        est0[o, 5:7] = np.sin(yaw[o] / 2 + dyaw), np.cos(yaw[o] / 2 + dyaw)
        est0[o, 7:] = gt[7:] + rng.normal(0, 0.04, 3)
        n2 = min(2 if o == 1 else (m2 if o % 3 else m2 // 2 + 1), m2)
        n3 = m3 if o % 4 else m3 // 3
        n = max(n2, n3, 1)
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(2.5, 4.0, n)
        hgt = rng.uniform(0.6, 2.0, n)
        pos = gt[:3] + np.stack([rad * np.cos(ang), rad * np.sin(ang), hgt],
                                axis=1)
        pwc = np.stack([_look_at(pos[i], gt[:3]) for i in range(n)])
        pcw = se3.se3_inv(torch.as_tensor(pwc))
        gt_t = torch.as_tensor(gt)
        bb = ell.project_bbox(gt_t, pcw, K).numpy()
        bb = bb + rng.normal(0, 0.5, bb.shape)
        bb[0, rng.randint(4)] = -1.0
        if o == 0 and n2 > 1:
            bb[1] = np.nan
        p2[o, :n2] = pcw.numpy()[:n2]
        b2[o, :n2] = bb[:n2]
        pr2[o, :n2] = rng.uniform(0.6, 1.0, n2)
        k2[o, :n2] = True
        if n3:
            meas = ell.transform_to(gt_t, torch.as_tensor(pwc[:n3])).numpy()
            turns = rng.randint(0, 4, n3)
            half = turns * np.pi / 4
            rq = np.stack([np.zeros(n3), np.zeros(n3), np.sin(half),
                           np.cos(half)], axis=1)
            meas[:, 3:7] = se3.quat_mul(torch.as_tensor(meas[:, 3:7]),
                                        torch.as_tensor(rq)).numpy()
            odd = turns % 2 == 1
            meas[odd, 7], meas[odd, 8] = meas[odd, 8].copy(), meas[odd, 7].copy()
            meas[:, :3] += rng.normal(0, 0.01, (n3, 3))
            meas[:, 7:] += rng.normal(0, 0.01, (n3, 3))
            p3[o, :n3] = pwc[:n3]
            me3[o, :n3] = meas
            pr3[o, :n3] = rng.uniform(0.5, 1.0, n3)
            k3[o, :n3] = True
    f32 = np.float32
    return {"est0": est0.astype(f32), "obj_mask": obj_mask,
            "pose2d_cw": p2.astype(f32), "bbox2d": b2.astype(f32),
            "prob2d": pr2.astype(f32), "mask2d": k2,
            "pose3d_wc": p3.astype(f32), "meas3d": me3.astype(f32),
            "prob3d": pr3.astype(f32), "mask3d": k3}
