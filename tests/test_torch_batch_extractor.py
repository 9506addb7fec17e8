"""The port's frame-batched extraction (frontend/batch_extractor.py) against
the JAX package's and against the port's own one-frame call, on the CPU.

One batch of B = 4 frames of the 6-object depth scene of
tests/test_torch_symmetry.py (seed 7, its labels: two dual reflections,
three reflections, one without a prior): frames 0 and 6 with their
detections, frame 3 without a detection, and a zero pad frame (all depth
0, frame 0's pose), as the offline mapper pads a tail batch.  Small size:
``cloud_capacity=2048``, ``cluster_min_size=30``, as
tests/test_torch_extractor.py.  Held here, on the depth, symmetry and
sparse-symmetry paths:
  * ``pack_frames_batch``: the flat vector, pad, tier, slices and flags
    EQUAL to JAX's, also with more than 32 detections in a frame, a gated
    detection and a frame whose box takes a larger tier;
  * the batched call against JAX's ``_extract_multi_packed`` at the
    whole-frame tolerances of the one-frame parity tests (valid flags
    equal, centre 1e-3, sorted scales 2e-3, the local z axis 1e-3, prob
    1e-5); on the symmetry paths frame 6's dual detection shows the open
    fault of ROADMAP.md queue 3 (the 9-plane LM), so those two cases are
    xfail, not strict, at those tolerances;
  * the batched call against the port's own one-frame call of each frame:
    BIT for bit on the depth path and, on the symmetry paths, for every
    detection but the dual reflections (the frame lane moves only the
    image's and the pose's base; the batch's larger cloud tier is
    padding).  A dual detection's plane azimuth is an ``atan2``, which
    PyTorch's CPU kernel computes in a vector body and a scalar tail that
    differ in the last bit, so where a detection's elements land depends
    on the other detections of the call; the 9-plane LM amplifies that ulp
    (ROADMAP.md queue 3) to 1.3e-3 in the centre and 3.3e-4 in prob on
    frame 6's dual detection.  Those rows are held to the whole-run
    tolerance of that fault, TOL = 2e-3 on the centre and sorted scales,
    1e-3 on the z axis and on prob, with valid flags equal.  On the card
    both the kernel (a block per detection and initial plane) and CUDA's
    elementwise atan2 are independent of the batch: chip_smoke.py holds
    the batched launches bit for bit to the per-frame ones;
  * the split protocol, with and without the u16 phase A, bit-equal to
    the monolithic batch;
  * the frame-indexed plain ``depth_cloud`` (with the border lane) against
    per-frame calls, with boxes on the first and the last row of a middle
    frame whose neighbours in the stack differ: the border's 4-neighbour
    test wraps inside the frame (a roll over the stacked [B*H, W] image
    would not);
  * the u16 phase A against JAX's ``_extract_multi_phase_a_q``: the port's
    quantization of JAX's phase-A buffer EQUAL to JAX's (q and tail), the
    port's own phase A within one code (its points are within 1.5e-6 of
    JAX's) and its tails within 1e-5; the host middle stage on the
    quantized copy equal to JAX's on the same copy.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.frontend import batch_extractor as jbx
from object_oriented_slam_tpu.frontend import extractor as jext
from object_oriented_slam_tpu_torch.core import se3
from object_oriented_slam_tpu_torch.frontend import batch_extractor as bx
from object_oriented_slam_tpu_torch.frontend import extractor as text
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.ops import depth_cloud as dc
from object_oriented_slam_tpu_torch.ops import filters

LABELS = [28, 57, 58, 28, 63, 59]
SCENE_KW = dict(n_objects=6, seed=7, radius_range=(1.3, 2.2),
                scale_range=(0.2, 0.4), labels=LABELS)
KW = dict(cloud_capacity=2048, cluster_min_size=30)
PATHS = {"depth": {}, "symmetry": dict(open_symmetry=True),
         "sparse": dict(open_symmetry=True, sparse_symmetry=True)}
PLANE = np.array([0.0, 0.0, 1.0, 0.0], np.float32)
REAL = (0, 2)       # the batch's frames with detections
TOL = 2e-3


@pytest.fixture(scope="module")
def seq():
    scene = tsyn.make_scene(**SCENE_KW)
    frames = list(tsyn.SyntheticDataset(scene, n_frames=12, orbit_radius=3.6,
                                        height=1.7).frames())
    cam = scene.camera
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)

    def rec(k, with_dets=True):
        _, _, pose, depth, _, det = frames[k]
        det = det if with_dets else np.zeros((0, 8))
        return (depth, det[:, 1:5], det[:, 5].astype(int),
                np.ones(len(det), bool), pose)

    pad_frame = (np.zeros_like(frames[0][3]), np.zeros((0, 4)),
                 np.zeros(0, int), np.zeros(0, bool), frames[0][2])
    packed = [rec(0), rec(3, False), rec(6), pad_frame]
    return dict(frames=frames, cam=cam, jcam=jcam, packed=packed)


_RUNS = {}


def _run(seq, path):
    """The port's batched call on ``path`` (cached: three tests read it)."""
    if path not in _RUNS:
        cfg = text.ExtractorConfig(**KW, **PATHS[path])
        fb = bx.pack_frames_batch(seq["cam"], cfg, seq["packed"], PLANE,
                                  min_pad=len(seq["packed"]))
        h = bx.dispatch_batch(fb, seq["cam"], device="cpu")
        _RUNS[path] = dict(cfg=cfg, fb=fb, handle=h, out=bx.fetch_batch(h))
    return _RUNS[path]


def _pack_both(seq, packed, cfg_kw, min_pad):
    fb = bx.pack_frames_batch(seq["cam"], text.ExtractorConfig(**cfg_kw),
                              packed, PLANE, min_pad=min_pad)
    jfb = jbx.pack_frames_batch(seq["jcam"], jext.ExtractorConfig(**cfg_kw),
                                packed, PLANE, min_pad=min_pad)
    return fb, jfb


@pytest.mark.parametrize("case", ["batch", "crowded", "tiers"])
def test_pack_frames_batch_matches_jax(seq, case):
    packed = list(seq["packed"])
    min_pad = 4
    kw = dict(KW, open_symmetry=True)
    if case == "crowded":
        # 40 detections in one frame (8 past the cap), a gated one, and
        # no pad floor
        d, bb, lab, run, pose = packed[0]
        reps = -(-40 // len(bb))
        bb40, lab40 = np.tile(bb, (reps, 1))[:40], np.tile(lab, reps)[:40]
        run40 = np.ones(40, bool)
        run40[1] = False
        packed[0] = (d, bb40, lab40, run40, pose)
        min_pad = 1
    elif case == "tiers":
        # a large box in a frame of its own takes the batch to a larger
        # tier, from the default capacity down
        d, bb, lab, run, pose = packed[2]
        big = np.concatenate([bb, [[10.0, 10.0, 600.0, 400.0]]])
        packed[2] = (d, big, np.append(lab, 59), np.append(run, True), pose)
        kw = dict(open_symmetry=True)
    fb, jfb = _pack_both(seq, packed, kw, min_pad)
    np.testing.assert_array_equal(fb.flat, jfb.flat)
    np.testing.assert_array_equal(fb.depths, jfb.depths)
    assert fb.depths.dtype == jfb.depths.dtype
    assert (fb.pad, fb.B, fb.need_s, fb.need_d, fb.slices) == \
        (jfb.pad, jfb.B, jfb.need_s, jfb.need_d, jfb.slices)
    assert fb.cfg.cloud_capacity == jfb.cfg.cloud_capacity
    assert {f.name: getattr(fb.cfg, f.name)
            for f in dataclasses.fields(fb.cfg)} == {
        f.name: getattr(jfb.cfg, f.name) for f in dataclasses.fields(jfb.cfg)
        if f.name in {g.name for g in dataclasses.fields(fb.cfg)}}
    if case == "crowded":
        assert fb.slices[0] == (0, 32) and fb.pad == 64
    if case == "tiers":
        assert fb.cfg.cloud_capacity == 16384
    assert bx.pack_frames_batch(seq["cam"], fb.cfg, packed, None) is None


_LM_FAULT = pytest.mark.xfail(strict=False, reason=(
    "fault logged in ROADMAP.md queue 3: the 9-plane symmetry LM's f32 "
    "rank-one solve; frame 6's dual detection ends 3.6e-3 from JAX's centre "
    "and 1.4e-3 from its prob in the port's one-frame call too (the batched "
    "rows equal it bit for bit: test_batched_call_equals_one_frame_calls), "
    "while JAX's batched rows are within 4e-7 of JAX's one-frame call"))


@pytest.mark.parametrize("path", [
    "depth", pytest.param("symmetry", marks=_LM_FAULT),
    pytest.param("sparse", marks=_LM_FAULT)])
def test_batched_call_matches_jax(seq, path):
    r = _run(seq, path)
    fb = r["fb"]
    jcfg = jext.ExtractorConfig(**dict(KW, **PATHS[path],
                                       cloud_capacity=fb.cfg.cloud_capacity))
    j = np.asarray(jbx._extract_multi_packed(
        jnp.asarray(fb.depths), jnp.asarray(fb.flat), seq["jcam"], jcfg,
        fb.pad, fb.B, fb.need_s, fb.need_d), np.float64)
    got = r["out"]
    assert got.shape == j.shape == (fb.pad, 12)
    np.testing.assert_array_equal(got[:, 11], j[:, 11])
    ok = got[:, 11] > 0.5
    assert ok.sum() >= 6
    e, je = got[ok], j[ok]
    np.testing.assert_allclose(e[:, :3], je[:, :3], atol=1e-3)
    np.testing.assert_allclose(np.sort(e[:, 7:10]), np.sort(je[:, 7:10]),
                               atol=2e-3)
    z = se3.quat_to_mat(torch.from_numpy(e[:, 3:7]))[:, :, 2].numpy()
    jz = se3.quat_to_mat(torch.from_numpy(je[:, 3:7]))[:, :, 2].numpy()
    np.testing.assert_allclose(z, jz, atol=1e-3)
    np.testing.assert_allclose(e[:, 10], je[:, 10], atol=1e-5)


@pytest.mark.parametrize("path", list(PATHS))
def test_batched_call_equals_one_frame_calls(seq, path):
    """Each real frame's rows equal the port's monolithic call of that frame
    alone, bit for bit; the empty and the pad frames have no rows and the
    padded lanes are invalid."""
    r = _run(seq, path)
    fb, out = r["fb"], r["out"]
    mono = text.make_extractor(seq["cam"], r["cfg"], device="cpu")
    for b in REAL:
        d, bb, lab, _, pose = seq["packed"][b]
        s, n = fb.slices[b]
        got, one = out[s:s + n], mono.fetch(mono(d, bb, lab, pose,
                                                 PLANE))[:n]
        assert mono.stats["cloud_tier"] <= fb.cfg.cloud_capacity
        dual = (lab == 28) if path != "depth" else np.zeros(n, bool)
        np.testing.assert_array_equal(got[~dual], one[~dual])
        np.testing.assert_array_equal(got[:, 11], one[:, 11])
        np.testing.assert_allclose(got[dual, :3], one[dual, :3], atol=TOL)
        np.testing.assert_allclose(np.sort(got[dual, 7:10]),
                                   np.sort(one[dual, 7:10]), atol=TOL)
        z = se3.quat_to_mat(torch.from_numpy(got[dual, 3:7]))[:, :, 2]
        oz = se3.quat_to_mat(torch.from_numpy(one[dual, 3:7]))[:, :, 2]
        np.testing.assert_allclose(z.numpy(), oz.numpy(), atol=1e-3)
        np.testing.assert_allclose(got[dual, 10], one[dual, 10], atol=1e-3)
        print(f"{path}: frame {b} bit-equal to its one-frame call: "
              f"{np.array_equal(got, one)} (dual rows: "
              f"{np.abs(got[dual] - one[dual]).max(initial=0):.3g})")
    assert fb.slices[1][1] == 0 and fb.slices[3][1] == 0
    total = sum(n for _, n in fb.slices)
    assert not (out[total:, 11] > 0.5).any()
    st = r["handle"].stats
    assert st["frames"] == 4 and st["pad"] == fb.pad
    assert st["cluster_converged"] and st["cluster_rounds"] > 0
    types = fb.flat[fb.pad * 6:fb.pad * 7]
    sym = path != "depth"
    assert st["sym_single"] == (int((types == 1).sum()) if sym else 0)
    assert st["sym_dual"] == (int((types == 2).sum()) if sym else 0)
    assert (types == 2).sum() >= 2 and (types == 1).sum() >= 2


@pytest.mark.parametrize("quantized", [False, True])
def test_split_batch_equals_monolithic(seq, quantized):
    """The split protocol on the sparse-symmetry path (phase A's row with
    the border lane, stage (g) in phase B): bit-equal to the monolithic
    batch; phase A launched alone leaves its buffer on the device."""
    r = _run(seq, "sparse")
    fb = r["fb"]
    h = bx.dispatch_batch_phase_a(fb, seq["cam"], quantized=quantized,
                                  device="cpu")
    cap = fb.cfg.cloud_capacity
    assert tuple(h.a_out.shape) == (fb.pad, 5 * cap + 5)
    if quantized:
        q, tail = (c.wait() for c in h.copies)
        assert q.dtype == torch.int16 and tuple(q.shape) == (fb.pad, cap, 3)
        assert tuple(tail.shape) == (fb.pad, 11)
    out = bx.fetch_batch(bx.dispatch_batch_phase_b(fb, h, seq["cam"],
                                                   device="cpu"))
    np.testing.assert_array_equal(out, r["out"])


def _striped_depths(B=3, H=48, W=64, seed=0):
    """B depth frames, each a wall at its own depth (2.0, 2.5, 3.0 m, 8 mm
    of noise): no border inside a frame but at its holes, while a frame's
    first and last rows lie more than the border's jump from the
    neighbouring frames' edge rows."""
    rng = np.random.default_rng(seed)
    d = (10000 + 2500 * np.arange(B, dtype=np.int32)[:, None, None]
         + rng.integers(0, 40, (B, H, W)).astype(np.int32))
    d[:, 10:-10][rng.random((B, H - 20, W)) < 0.02] = 0
    return d


@pytest.mark.parametrize("border", [False, True])
def test_depth_cloud_frame_lane_equals_per_frame(border):
    """depth_cloud_plain / depth_cloud_border_plain with the frame lane
    against one call per frame: boxes on the first and the last row of the
    middle frame, and across all of it; every output bit-equal, R one
    rotation a detection."""
    from object_oriented_slam_tpu_torch.core.camera import Camera
    B, H, W = 3, 48, 64
    cam = Camera(fx=50.0, fy=50.0, cx=31.5, cy=23.5, scale=5000.0, width=W,
                 height=H)
    depths = torch.from_numpy(_striped_depths(B, H, W))
    rng = np.random.default_rng(1)
    # three poses near the identity (the clouds stay above the plane)
    poses = np.concatenate([rng.normal(0, 0.3, (B, 3)),
                            rng.normal(0, 0.1, (B, 3)), np.ones((B, 1))], 1)
    poses[:, 3:] /= np.linalg.norm(poses[:, 3:], axis=1, keepdims=True)
    poses = torch.from_numpy(poses.astype(np.float32))
    boxes = torch.tensor([[5, 0, 40, 9], [20, 40, 64, 48], [0, 0, 64, 48],
                          [3, 0, 30, 48], [8, 2, 50, 20]], dtype=torch.float32)
    frame = torch.tensor([1, 1, 1, 0, 2], dtype=torch.int32)
    plane = torch.tensor([0.0, 0.0, 1.0, 0.5])
    fn = dc.depth_cloud_border if border else dc.depth_cloud
    args = (cam, 0.01, 6.0, 0.05, 1024)
    got = fn(depths, boxes, poses, plane, *args, frame=frame)
    for d in range(len(boxes)):
        f = int(frame[d])
        want = fn(depths[f], boxes[d:d + 1], poses[f], plane, *args)
        g_cloud, w_cloud = (got[0], want[0]) if border else (got, want)
        for name in ("pts_w", "m2", "center_w", "ok_points", "ok_center",
                     "pts_v", "cells_v"):
            torch.testing.assert_close(getattr(g_cloud, name)[d],
                                       getattr(w_cloud, name)[0],
                                       rtol=0, atol=0, msg=name)
        torch.testing.assert_close(g_cloud.R_wc[d], w_cloud.R_wc,
                                   rtol=0, atol=0)
        if border:
            torch.testing.assert_close(got[1][d], want[1][0], rtol=0, atol=0)
    assert bool(got[0].ok_points.all() if border else got.ok_points.all())
    if border:
        # the case discriminates: rolled over the stack, the middle frame's
        # first and last rows would see the neighbouring frames' rows
        mask = filters.depth_border_mask(depths, cam.scale)
        stacked = filters.depth_border_mask(depths.reshape(B * H, W),
                                            cam.scale).reshape(B, H, W)
        assert not torch.equal(mask[1, 0], stacked[1, 0])
        assert not torch.equal(mask[1, -1], stacked[1, -1])
        for b in range(B):
            assert torch.equal(mask[b], filters.depth_border_mask(
                depths[b], cam.scale))


def test_phase_a_quantized_matches_jax(seq):
    r = _run(seq, "depth")
    fb = r["fb"]
    jcfg = jext.ExtractorConfig(**dict(KW,
                                       cloud_capacity=fb.cfg.cloud_capacity))
    a_out, q, tail = (np.asarray(t) for t in jbx._extract_multi_phase_a_q(
        jnp.asarray(fb.depths), jnp.asarray(fb.flat), seq["jcam"], jcfg,
        fb.pad, fb.B))
    # the quantization itself, on JAX's own buffer: equal
    pq, pt = bx.quantize_phase_a(torch.from_numpy(a_out.copy()), fb.cfg)
    np.testing.assert_array_equal(pq.numpy().view(np.uint16), q)
    np.testing.assert_array_equal(pt.numpy(), tail)
    # the port's phase A: its points within 1.5e-6 of JAX's, so a code
    # moves by at most one; the masked lanes are the same
    h = bx.dispatch_batch_phase_a(fb, seq["cam"], quantized=True,
                                  device="cpu")
    np.testing.assert_allclose(h.a_out.numpy(), a_out, atol=1.5e-6)
    hq = h.copies[0].wait().numpy().view(np.uint16)
    ht = h.copies[1].wait().numpy()
    np.testing.assert_array_equal(hq == bx.Q_MASKED, q == bx.Q_MASKED)
    assert np.abs(hq.astype(np.int64) - q.astype(np.int64)).max() <= 1
    np.testing.assert_allclose(ht, tail, atol=1e-5)
    # the host middle stage on one quantized copy: the port's and JAX's
    # (native/src/cluster.cpp through each package's loader) agree
    flat_b, sel, survivors = bx.host_cluster_select_multi_q(fb, q, tail)
    jfb = jbx.FrameBatch(depths=fb.depths, flat=fb.flat, cfg=jcfg,
                         pad=fb.pad, B=fb.B, need_s=fb.need_s,
                         need_d=fb.need_d, slices=fb.slices)
    jflat_b, jsel = jbx.host_cluster_select_multi_q(jfb, q, tail)
    np.testing.assert_array_equal(flat_b, jflat_b)
    np.testing.assert_array_equal(sel, jsel > 0.5)
    assert survivors > 0 and (flat_b[fb.pad * 5:fb.pad * 6] > 0.5).sum() >= 6
