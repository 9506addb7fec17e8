"""K11, the SLAM edge kernel (csrc/slam_edges.cu), against its plain PyTorch
version.

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped elsewhere.  The machine
with the card has no JAX, so run this file without the JAX test setup:

    python -m pytest tests/test_torch_slam_kernels.py --noconftest -q

The graph is examples/torch_slam_edges_on_cpu.py's orbit (12 frames, 2
objects, one 2D edge with a non-finite residual, one 3D measurement a
quarter turn of yaw away) with its estimates perturbed from a seed, and
its yaw graph (a measurement half a turn away, two yaw candidates tied at
the least norm, a candidate with a NaN norm after finite ones).
Tolerances: every edge of the Jacobian launch's outputs, its largest
distance from the plain version's float64 evaluation, within 1e-4 of the
output's largest entry, or within 4 times the plain version's own distance
from it on that edge, on the card or on the CPU, where that is larger (the
projected-bbox chain loses digits in f32 on some views, by an amount that
differs between any two f32 evaluations: the plain version on the CPU and
on the card differ there as far as the kernel and the plain version do);
the non-finite entries in the same places;
chi2 likewise at 1e-5; repeats bit-equal; every built count of tangent
directions a thread bit-equal to the entry point's launch;
one optimize_slam call on the card within 2e-3 of the CPU's
(tests/test_slam_banded.py's banded-dense tolerance).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from object_oriented_slam_tpu_torch.backend import (LMConfig, slam_ba,
                                                    slam_kernels)

torch.set_num_threads(1)    # the test workers share the CPU

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_slam_edges_on_cpu",
        os.path.join(ROOT, "examples", "torch_slam_edges_on_cpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _yaw():
    return _example().yaw_graph()


def _orbit(seed=3):
    g, K, normal = _example().orbit_graph(seed=seed)
    rng = np.random.default_rng(seed)
    objects = g.objects.clone()
    objects[:, :3] += torch.tensor(rng.normal(0, 0.05, (2, 3)),
                                   dtype=torch.float32)
    return g._replace(objects=objects), K, normal


def _to(g, K, normal, device, dtype=torch.float32):
    g = type(g)(*[t.to(device, dtype) if t.is_floating_point()
                  else t.to(device) for t in g])
    return g, K.to(device, dtype), normal.to(device, dtype)


def _against_plain(graph, device):
    """K11 on the card against its plain version on ``graph()``'s graph at
    the module's tolerances; repeats bit-equal.  Returns (graph on the
    card, the edge terms)."""
    g, K, n = _to(*graph(), device)
    g64, K64, n64 = _to(*graph(), device, torch.float64)
    args = (g.poses_cw, g.objects, g, K, n)
    got = slam_kernels.edge_terms(*args)
    again = slam_kernels.edge_terms(*args)
    want = slam_ba.edge_terms_plain(*args)
    want64 = slam_ba.edge_terms_plain(g64.poses_cw, g64.objects, g64, K64, n64)
    gc, Kc, nc = graph()
    want_cpu = slam_ba.edge_terms_plain(gc.poses_cw, gc.objects, gc, Kc, nc)
    for a, b, c, p, d in zip(got, want, want64, want_cpu, again):
        assert torch.equal(a.view(torch.int32), d.view(torch.int32))
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        E = b.shape[0]
        a, b, c, p = (t.to(device).double().reshape(E, -1)
                      for t in (a, b, c, p))
        fin = torch.isfinite(b) & torch.isfinite(c) & torch.isfinite(p)
        a, b, c, p = (torch.where(fin, t, 0.0) for t in (a, b, c, p))
        own = torch.maximum((b - c).abs(), (p - c).abs()).amax(1)
        tol = torch.clamp(4 * own, min=1e-4 * float(b.abs().max()))
        assert bool(((a - c).abs().amax(1) <= tol).all())
    runs = [slam_kernels.chi2(*args) for _ in range(3)]
    cp = float(slam_ba._chi2_plain(*args))
    c64 = float(slam_ba._chi2_plain(g64.poses_cw, g64.objects, g64, K64, n64))
    for c in runs[1:]:
        assert torch.equal(c.view(torch.int32), runs[0].view(torch.int32))
    assert abs(float(runs[0]) - cp) <= max(1e-5 * abs(cp), 4 * abs(cp - c64))
    return g, got


def test_k11_matches_its_plain_version(device):
    g, got = _against_plain(_orbit, device)
    assert not bool(torch.isfinite(g.e2_bbox).all())
    # the edge with the non-finite residual is zeroed, r and J alike
    bad = ~torch.isfinite(g.e2_bbox).all(1)
    for t in got[:3]:
        assert bool((t[bad] == 0).all())


def test_k11_yaw_choice_matches_its_plain_version(device):
    """The yaw graph: the half-turn measurement, the tie and the NaN
    candidate against the plain version at the same tolerances; the edge
    whose winner's norm is NaN is zeroed."""
    g, got = _against_plain(_yaw, device)
    for t in got[3:6]:
        assert bool((t[-1] == 0).all())


@pytest.mark.parametrize("graph", ["orbit", "yaw"])
def test_k11_every_lanes_count_equals_the_launched_one(device, graph):
    """The Jacobian kernel at 1, 2, 3 and 5 tangent directions a thread:
    every output bit-equal to the entry point's launch."""
    g, K, n = _to(*(_orbit() if graph == "orbit" else _yaw()), device)
    args = (g.poses_cw, g.objects, g, K, n)
    want = slam_kernels.edge_terms(*args)
    for lanes in slam_kernels.LANES_BUILT:
        got = slam_kernels.edge_terms_at(*args, lanes)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_k11_refuses_cpu_and_f64_tensors(device):
    g, K, n = _orbit()
    for fn in (slam_kernels.edge_terms, slam_kernels.chi2):
        with pytest.raises(ValueError, match="CUDA"):
            fn(g.poses_cw, g.objects, g, K, n)
        gd, Kd, nd = _to(g, K, n, device)
        with pytest.raises(ValueError, match="CUDA"):
            fn(gd.poses_cw, gd.objects, gd, Kd, n)
        g64, K64, n64 = _to(g, K, n, device, torch.float64)
        with pytest.raises(TypeError, match="float32"):
            fn(g64.poses_cw, g64.objects, g64, K64, n64)


def test_optimize_slam_launches_k11_twice_an_iteration(device):
    """One optimize_slam call on CUDA tensors: K11's Jacobian instantiation
    once an iteration, its chi2 one once more, no host synchronisation
    inside (the synchronisation check set to raise), a second call
    bit-equal, and the CPU's plain result within 2e-3."""
    g, K, n = _orbit()
    gd, Kd, nd = _to(g, K, n, device)
    cfg = LMConfig(iters=4)
    for k in slam_kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        poses, objs, chi2 = slam_ba.optimize_slam(gd, Kd, nd, cfg,
                                                  banded=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert slam_kernels.EDGE_TERMS.launches == 4
    assert slam_kernels.CHI2.launches == 5
    again = slam_ba.optimize_slam(gd, Kd, nd, cfg, banded=True)
    for a, b in zip((poses, objs, chi2), again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    p_c, o_c, c_c = slam_ba.optimize_slam(g, K, n, cfg, banded=True)
    assert float((poses.cpu() - p_c).abs().max()) <= 2e-3
    assert float((objs.cpu() - o_c).abs().max()) <= 2e-3
    assert float(chi2) < float(slam_ba._chi2(g.poses_cw, g.objects, g, K, n))
