"""K12 (``dense_fuse``, csrc/dense_fuse.cu) against its plain PyTorch
version, on an empty map and on a filled one, and on the cases of
examples/torch_dense_fuse_on_cpu.py (both of its paths).

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped elsewhere.  The machine
with the card has no JAX, so run this file without the JAX test setup:

    python -m pytest tests/test_torch_dense_kernels.py --noconftest -q

Tolerance: bit for bit against the plain version on the CPU (the kernel
adds each segment in sorted order, the CPU's ``index_add_`` order, and
rounds every operation on its own); against the plain version on the card
(whose ``index_add_`` adds with atomics in any order) masks equal, points
within 1e-6 and colours within 1e-4.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from object_oriented_slam_tpu_torch.core.camera import Camera
from object_oriented_slam_tpu_torch.ops import dense_fuse as df
from object_oriented_slam_tpu_torch.system.dense_builder import DenseBuilder

torch.set_num_threads(1)    # the test workers share the CPU

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the path each fuse of a case is built to take (0 fast, 1 general)
PATHS = {
    "empty": [0], "filled": [0, 0, 0], "shuffled": [1, 0],
    "shrink": [0, 0, 0], "wide-still": [0], "wide-moved": [1], "seam": [1],
    "wide-clipped": [0],
    "ties": [0], "refloor": [1], "overflow": [0], "overflow-general": [1],
    "frame-limit": [0], "frame-past": [0], "bucket-large": [0],
    "bucket-mid": [0], "bucket-limit": [0],
}

CAM = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _frame(seed, yaw):
    """A rippled, tilted wall with holes and random colours, and a pose."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float64)
    z = 1.2 + 0.003 * xx + 0.08 * np.sin(yy / 17.0 + seed)
    depth = (z * CAM.scale).astype(np.int32)
    depth[rng.random(depth.shape) < 0.05] = 0
    rgb = rng.integers(0, 256, (480, 640, 3)).astype(np.float32)
    pose = np.array([0.1 * seed, 0.0, 0.02, 0.0, np.sin(yaw / 2), 0.0,
                     np.cos(yaw / 2)], np.float32)
    return depth, rgb, pose


def _fuse(device, state, frame, capacity, stride, leaf=0.01):
    depth, rgb, pose = (torch.as_tensor(a, device=device) for a in frame)
    return df.dense_fuse(*(t.to(device) for t in state), depth, rgb, pose,
                         CAM, stride, leaf, capacity, 6.0)


def _empty(capacity):
    return (torch.zeros(capacity, 3), torch.zeros(capacity, 3),
            torch.zeros(capacity, dtype=torch.bool))


@pytest.mark.parametrize("capacity,stride", [(1 << 19, 4), (4096, 8)])
def test_fuse_matches_plain_empty_and_filled(device, capacity, stride):
    """Frame 1 into an empty map, frame 2 into the filled one: bit-equal to
    the plain version on the CPU, one launch count a fuse."""
    state = _empty(capacity)
    for seed, yaw in ((1, 0.0), (2, 0.25)):
        frame = _frame(seed, yaw)
        before = df.DENSE_FUSE.launches
        got = [t.cpu() for t in _fuse(device, state, frame, capacity, stride)]
        torch.cuda.synchronize()
        assert df.DENSE_FUSE.launches == before + 1
        want = _fuse(torch.device("cpu"), state, frame, capacity, stride)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        on_card = [t.cpu() for t in df.dense_fuse_plain(
            *(t.to(device) for t in state),
            *(torch.as_tensor(a, device=device) for a in frame), CAM, stride,
            0.01, capacity, 6.0)]
        assert torch.equal(got[2], on_card[2])
        assert float((got[0] - on_card[0]).abs().max()) <= 1e-6
        assert float((got[1] - on_card[1]).abs().max()) <= 1e-4
        state = want
    assert int(state[2].sum()) > 1000


def test_builder_on_the_card_matches_cpu(device):
    """DenseBuilder on the card (its buffers reused every frame, the map
    alternating between them) against the CPU builder, three frames."""
    gpu = DenseBuilder(CAM, capacity=8192, stride=8, device=device)
    cpu = DenseBuilder(CAM, capacity=8192, stride=8, device="cpu")
    for seed in (1, 2, 3):
        depth, rgb, pose = _frame(seed, 0.1 * seed)
        rgb8 = rgb.astype(np.uint8)
        gpu.process_frame(rgb8, depth, pose)
        cpu.process_frame(rgb8, depth, pose)
    work = gpu._work
    for g, c in zip((gpu.pts, gpu.rgb, gpu.mask), (cpu.pts, cpu.rgb, cpu.mask)):
        assert torch.equal(g.cpu(), c)
    assert gpu._work is work
    gpu.process_frame(None, *_frame(4, 0.0)[::2])
    assert gpu.get_map()[0].shape[0] > 0


def test_wrapper_checks_inputs(device):
    state = [t.to(device) for t in _empty(64)]
    depth, rgb, pose = (torch.as_tensor(a, device=device)
                        for a in _frame(1, 0.0))
    with pytest.raises(TypeError):
        df.dense_fuse(*state, depth.float(), rgb, pose, CAM, 4, 0.01, 64, 6.0)
    with pytest.raises(ValueError):
        df.dense_fuse(*state, depth, rgb, pose, CAM, 4, 0.01, 32, 6.0)


@pytest.fixture(scope="module")
def cases():
    spec = importlib.util.spec_from_file_location(
        "torch_dense_fuse_on_cpu",
        os.path.join(ROOT, "examples", "torch_dense_fuse_on_cpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.cases()


@pytest.mark.parametrize("name", sorted(PATHS))
def test_fuse_cases_match_plain_on_both_paths(device, cases, name):
    """The CPU build's cases on the card: every map bit-equal to the plain
    version on the CPU, a second run bit-equal, one launch count a fuse,
    the tally on the path the map's keys call for (the fast merge, or the
    general radix sort: a shuffled map, a moved minimum cell over clipped
    rows, a re-floored centroid)."""
    mod, all_cases = cases
    case = all_cases[name]
    want = mod.plain_chain(case)
    before = df.DENSE_FUSE.launches
    got, paths = mod.run_case(
        case, lambda cap, H, W, stride: df.FuseWork(cap, H, W, stride,
                                                    device))
    torch.cuda.synchronize()
    assert df.DENSE_FUSE.launches == before + len(case[4])
    again, _ = mod.run_case(
        case, lambda cap, H, W, stride: df.FuseWork(cap, H, W, stride,
                                                    device))
    for g, a, w in zip(got, again, want):
        for x, y, z in zip(g, a, w):
            assert x.dtype == z.dtype and np.array_equal(x, z)
            assert np.array_equal(x, y)
    assert paths == mod.expected_paths(case) == PATHS[name]
