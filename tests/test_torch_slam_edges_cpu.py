"""K11 (csrc/slam_edges.cu) built for the CPU with g++
(examples/torch_slam_edges_on_cpu.py: the kernels' source with their
launches emulated, a block's threads as std::threads and a warp's shuffles
between barriers), held bit for bit against the outputs the source gave
before its redesign (tests/torch_slam_edges_parent.npz, made by
tests/torch_slam_edges_parent.py from the old tree's own host build).

The graphs: the example's ``orbit_graph()`` and ``yaw_graph()``, whose 3D
edges take every branch of the yaw choice (the last candidate by a
strictly smaller norm, a tie of two at the least norm, a NaN norm after
finite ones).  Tolerance: bit for bit on every live edge (non-zero weight)
and every gravity row, and on chi2, at every built lanes count and block
size: the choice reads primal values, which a dual's chain computes by the
float chain's operations, and a dual's tangent directions never mix; the
chi2 launch adds the same terms in the same tree.  Host libm, not the
card's: the card's bits are held in tests/test_torch_slam_kernels.py.
"""
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)    # the test workers share the CPU

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_slam_edges_parent as parent  # noqa: E402

LANES = (1, 2, 3, 5)


@pytest.fixture(scope="module")
def k11(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K11 for the CPU")
    path = os.path.join(ROOT, "examples", "torch_slam_edges_on_cpu.py")
    spec = importlib.util.spec_from_file_location("torch_slam_edges_on_cpu",
                                                  path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    work = str(tmp_path_factory.mktemp("k11"))
    return ex, ex.build(workdir=work), parent.load_store(), parent.graphs(), \
        work


def _bits(t):
    return np.asarray(t).view(np.int32)


def _live(g):
    """Per output r2 ... Jg, the rows the contract holds: live edges and
    every gravity row."""
    masks = [g.e2_w != 0] * 3 + [g.e3_w != 0] * 3 + [g.odo_w != 0] * 3
    return [m.numpy() for m in masks] + [np.ones(g.grav_w.shape[0], bool)] * 2


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("graph", parent.GRAPHS)
def test_k11_on_the_cpu_equals_the_stored_outputs(k11, graph, lanes):
    """Every output of the Jacobian launch at ``lanes`` on the graph's live
    edges, chi2 and each edge's chi2 term bit-equal to the stored ones; a
    launch repeats bit for bit."""
    ex, lib, store, graphs, _ = k11
    g, K, normal = graphs[graph]
    want = store[graph]
    runs = [ex.chains(lib, g, K, normal, lanes=lanes) for _ in range(2)]
    for got, terms, chi2 in runs:
        for name, t, live in zip(parent.NAMES, got, _live(g)):
            assert np.array_equal(_bits(t)[live], _bits(want[name])[live]), \
                name
        assert np.array_equal(_bits(terms), _bits(want["sq"]))
        assert _bits(chi2) == _bits(want["chi2"])
    for a, b in zip(runs[0][0], runs[1][0]):
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("graph", parent.GRAPHS)
def test_k11_chi2_launches_share_one_ticket_counter(k11, graph):
    """Three chi2 launches on one ticket counter, as the entry point's on
    one stream: each leaves the counter at zero and gives the stored
    chi2's bits."""
    ex, lib, store, graphs, _ = k11
    g, K, normal = graphs[graph]
    ticket = torch.zeros(1, dtype=torch.int32)
    for _ in range(3):
        _, _, chi2 = ex.chains(lib, g, K, normal, ticket=ticket)
        assert int(ticket) == 0
        assert _bits(chi2) == _bits(store[graph]["chi2"])


@pytest.mark.parametrize("graph", parent.GRAPHS)
def test_k11_jacobians_identical_across_lanes(k11, graph):
    """r and J bit-identical, every entry, at 1, 2, 3 and 5 tangent
    directions a thread."""
    ex, lib, _, graphs, _ = k11
    g, K, normal = graphs[graph]
    outs = [ex.chains(lib, g, K, normal, lanes=L)[0] for L in LANES]
    for other in outs[1:]:
        for name, a, b in zip(parent.NAMES, outs[0], other):
            assert np.array_equal(_bits(a), _bits(b)), name


def test_yaw_graph_takes_every_branch_of_the_choice(k11):
    """The yaw graph's 3D edges, by the kernels' own scoring: the half-turn
    measurement's winner is the last candidate, strictly below the others;
    the origin frame's first edge ties its -90 and +90 deg candidates at
    the least norm and takes the first; its second has a NaN norm for the
    last candidate only, and takes it."""
    ex, lib, _, graphs, _ = k11
    g, K, normal = graphs["yaw"]
    norms, win = ex.yaw_choice(lib, g, K, normal)
    half, tie, nan = 7, g.e3_w.shape[0] - 2, g.e3_w.shape[0] - 1
    assert int(win[half]) == 3 and bool((norms[half, 3] < norms[half, :3])
                                        .all())
    assert int(win[tie]) == 0 and _bits(norms[tie, 0]) == _bits(
        norms[tie, 2])
    assert bool((norms[tie, 0] < norms[tie, [1, 3]]).all())
    assert int(win[nan]) == 3 and bool(torch.isnan(norms[nan, 3]))
    assert bool(torch.isfinite(norms[nan, :3]).all())


@pytest.mark.parametrize("graph", parent.GRAPHS)
def test_k11_operation_count_of_the_winner_alone(k11, graph):
    """count_ops: with every candidate's tangents it gives the old chains'
    stored count, the chi2 count is the stored one, and the Jacobian's
    count with the winner's tangents alone is below it on the 3D edges
    and equal elsewhere."""
    ex, _, store, graphs, work = k11
    g, K, normal = graphs[graph]
    ops = ex.count_ops(g, K, normal, work)
    want = store[graph]
    assert [ops["every_candidate"][k] for k in parent.KINDS] == list(
        want["ops_jac"])
    assert [ops["slam_chi2"][k] for k in parent.KINDS] == list(
        want["ops_chi2"])
    for k in parent.KINDS:
        if k == "e3":
            assert ops["slam_edge_terms"][k] < ops["every_candidate"][k]
        else:
            assert ops["slam_edge_terms"][k] == ops["every_candidate"][k]
