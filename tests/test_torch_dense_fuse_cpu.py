"""K12 (``dense_fuse``, csrc/dense_fuse.cu) built for the CPU with g++
(examples/torch_dense_fuse_on_cpu.py: the kernel's source, its blocks run
as std::threads behind ``FuseWork``'s own buffers and launch arguments),
held against its plain version on both of its paths.

Tolerance: bit for bit.  The kernel sums each segment in the plain
version's order (the map's rows in index order, then the frame's, which a
stable sort of the concatenated keys gives), and every multiply, add and
divide rounds on its own in both.  Each fuse's path, counted on the
device, is the one its map's keys call for: the fast merge where the map's
keys under the new minimum cell do not descend, the general radix sort
where they do.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from object_oriented_slam_tpu_torch.ops import dense_fuse as df

torch.set_num_threads(1)    # the test workers share the CPU

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


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def k12(tmp_path_factory):
    mod = _module("torch_dense_fuse_on_cpu",
                  os.path.join(ROOT, "examples", "torch_dense_fuse_on_cpu.py"))
    lib = mod.build(os.path.join(ROOT, "object_oriented_slam_tpu_torch",
                                 "csrc", "dense_fuse.cu"),
                    str(tmp_path_factory.mktemp("k12") / "k12.so"))
    return mod, lib, mod.cases()


@pytest.mark.parametrize("name", sorted(PATHS))
def test_k12_source_built_for_the_cpu_equals_plain(k12, name):
    """Every map bit-equal to dense_fuse_plain's, a second run bit-equal,
    each fuse's tally on the path its keys call for, and that path the one
    the case is built for: an empty map, three frames each into the last
    one's map, a shuffled map (and a frame into its output), a small map
    over a buffer that held a larger one, a map 1,500 cells wide with the
    frame inside it, moving the minimum cell or with clipped cells (its
    keys then radix-sorted), a descent only where two blocks' rows meet,
    rows that share keys, a
    centroid that floors into the next cell, overflow at capacity on each
    path, a frame of 19,520 strided pixels sorted bucket by bucket and one
    of 21,000 with larger buckets, and a patch that fills one bucket of the
    frame sort with 65 pixels (one past a warp's sort: the block ranks
    it), 1,024 (the most the block ranks) or 1,025 (the frame's keys then
    take the general sort)."""
    mod, lib, cases = k12
    case = cases[name]
    want = mod.plain_chain(case)
    got, paths = mod.run_case(case, mod.on_cpu(lib))
    again, _ = mod.run_case(case, mod.on_cpu(lib))
    for g, a, w in zip(got, again, want):
        for x, y, z in zip(g, a, w):
            assert x.dtype == z.dtype and np.array_equal(x, z)
            assert np.array_equal(x, y)
    assert paths == mod.expected_paths(case) == PATHS[name]


@pytest.mark.parametrize("name", ["frame-past", "shuffled"])
def test_k12_source_built_for_the_cpu_in_one_block(k12, name):
    """The same with a launch of one block: the general sort's first pass
    over a chunk too large to stage in shared memory (the 21,000-pixel
    frame's keys in one block, past DF_STAGE_MAX) writes straight to device
    memory; smaller chunks are staged (the shuffled map)."""
    mod, lib, cases = k12
    case = cases[name]
    got, paths = mod.run_case(case, mod.on_cpu(lib, blocks=1))
    for g, w in zip(got, mod.plain_chain(case)):
        for x, z in zip(g, w):
            assert np.array_equal(x, z)
    assert paths == PATHS[name]


def test_k12_cases_reach_what_they_name(k12):
    """The limits the cases stand at: the frame sort's buckets one past a
    warp's 64 pixels, at the block's 1,024 and one past, the large frames past the 19,200 strided
    pixels of a 640 x 480 frame at stride 4 and, for one block, past what
    a pass stages in shared memory, the overflow cases end full, the
    shrinking map ends smaller than the one its buffer held."""
    mod, lib, cases = k12
    assert lib.emu_scratch_ints(4096, 3072) == df.scratch_ints(4096, 3072)
    frames = {}
    for name in ("frame-limit", "frame-past"):
        cap, leaf, cam, stride, seq = cases[name]
        hs, ws = df.frame_grid(*seq[0][1].shape, stride)
        frames[name] = hs * ws
    assert frames == {"frame-limit": 19520, "frame-past": 21000}
    assert frames["frame-past"] > lib.emu_stage_max() > 19520
    for name in ("overflow", "overflow-general"):
        assert int(mod.plain_chain(cases[name])[-1][2].sum()) == \
            cases[name][0]
    live = [int(m[2].sum()) for m in mod.plain_chain(cases["shrink"])]
    assert live[2] < live[0] < live[1]
    # the frame sort's buckets: a warp sorts one of at most 64 pixels, the
    # block one of at most 1,024; a larger one sends the frame's keys to
    # the general sort
    smoke = _module("chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    sizes = {}
    for name in ("empty", "frame-limit", "frame-past", "bucket-limit",
                 "bucket-mid", "bucket-large", "wide-clipped"):
        cap, leaf, cam, stride, seq = cases[name]
        m, depth, rgb, pose_wc = seq[0]
        sizes[name] = smoke.dense_largest_bucket(
            tuple(torch.as_tensor(a) for a in m),
            mod.frame_tensors(depth, rgb, pose_wc), cam, leaf, stride, 6.0)
    assert 0 < sizes["empty"] <= 64 and 0 < sizes["frame-limit"] <= 64
    assert sizes["bucket-mid"] == 65 and sizes["bucket-limit"] == 1024
    assert sizes["bucket-large"] == 1025 and sizes["frame-past"] > 1024
    assert sizes["wide-clipped"] == 0       # a clipped cell: no buckets


def test_fuse_work_load_zeroes_masked_rows():
    """A copied map's masked rows are zeroed (the kernel clears only rows
    an older map left set, so every map it reads keeps unset rows zero);
    a map that is already the current prefix is not copied."""
    work = df.FuseWork(8, 4, 4, 1, "cpu")
    pts = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    col = pts + 100
    mask = torch.tensor([True, False] * 4)
    work.load(pts, col, mask)
    p, c, m = work.map()
    assert torch.equal(m, mask)
    assert torch.equal(p[mask], pts[mask]) and torch.equal(c[mask], col[mask])
    assert not p[~mask].any() and not c[~mask].any()
    ptr = p.data_ptr()
    work.load(*work.map())
    assert work.map()[0].data_ptr() == ptr
