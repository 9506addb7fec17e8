"""K11's outputs as csrc/slam_edges.cu computed them before its redesign
(commit 70bb621), stored for tests/test_torch_slam_edges_cpu.py.

    git archive 70bb621 | tar -x -C OLD
    python tests/torch_slam_edges_parent.py OLD

writes tests/torch_slam_edges_parent.npz: for each graph of GRAPHS (the
current examples/torch_slam_edges_on_cpu.py's ``orbit_graph()`` and
``yaw_graph()``) a digest of its inputs (``<graph>_digest``), the eleven
outputs of the Jacobian instantiation (``<graph>_r2`` ... ``_Jg``), each
edge's gated sum of squares of the float instantiation (``_sq``), the
chi2 that the old launch's sum tree makes of them (``_chi2``: 128 edges a
block, the xor-shuffle 16 -> 1 in each warp, the warps in order, the
blocks in order) and the operations the old chains' count gives the live
edges (``_ops_jac``, ``_ops_chi2``, per kind e2 e3 odo grav).  Each is
computed by the old tree's own examples/torch_slam_edges_on_cpu.py
(``build``, ``chains``, ``count_ops``: its chains built with g++, its
threads dealt as its kernel dealt them).  ``load_store`` refuses a store
whose inputs are not today's graphs.  Needs g++; ~20 s.
"""
import hashlib
import importlib.util
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STORE = os.path.join(HERE, "torch_slam_edges_parent.npz")
GRAPHS = ("orbit", "yaw")
NAMES = ("r2", "Jp2", "Jo2", "r3", "Jp3", "Jo3", "ro", "Ji", "Jj", "rg", "Jg")
KINDS = ("e2", "e3", "odo", "grav")


def example(root):
    """examples/torch_slam_edges_on_cpu.py of the tree at ``root``."""
    path = os.path.join(root, "examples", "torch_slam_edges_on_cpu.py")
    spec = importlib.util.spec_from_file_location(
        f"torch_slam_edges_on_cpu_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def graphs():
    """{name: (SlamGraph on the CPU, K, normal)} of this tree's example."""
    ex = example(ROOT)
    return {"orbit": ex.orbit_graph(), "yaw": ex.yaw_graph()}


def digest(g, K, normal):
    """SHA-256 of every field of the graph, K and the normal, in order."""
    h = hashlib.sha256()
    for t in (*g, K, normal):
        a = t.detach().cpu().contiguous().numpy()
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def sum_tree(sq):
    """The old chi2 launch's sum of the edges' terms ``sq`` [n] in float32:
    blocks of 128 edges, in each warp of 32 the xor-shuffle pattern (off
    16, 8, 4, 2, 1: each lane adds its partner's value to its own) read at
    lane 0, the block's four warps added in order, then the blocks' sums in
    block order."""
    sq = np.asarray(sq, np.float32)
    blocks = max(1, -(-sq.size // 128))
    s = np.zeros(blocks * 128, np.float32)
    s[:sq.size] = sq
    s = s.reshape(blocks, 4, 32)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ off]
    warp = s[..., 0]
    per_block = warp[:, 0]
    for w in range(1, 4):
        per_block = per_block + warp[:, w]
    total = per_block[0]
    for b in per_block[1:]:
        total = np.float32(total + b)
    return np.float32(total)


def load_store():
    """{graph: {name: array}} of the store; raises where a graph's inputs
    differ from the ones the store was made from."""
    stored = dict(np.load(STORE))
    out = {}
    for name, (g, K, normal) in graphs().items():
        if str(stored[f"{name}_digest"]) != digest(g, K, normal):
            raise AssertionError(
                f"{STORE} was made from other inputs ({name} graph differs): "
                f"run tests/torch_slam_edges_parent.py on the old tree again")
        out[name] = {k[len(name) + 1:]: v for k, v in stored.items()
                     if k.startswith(name + "_")}
    return out


def main(argv):
    inputs = graphs()
    old = example(os.path.abspath(argv[0]))
    work = tempfile.mkdtemp(prefix="slam_edges_parent_")
    lib = old.build(workdir=work)
    out = {}
    for name, (g, K, normal) in inputs.items():
        got, sq = old.chains(lib, g, K, normal)
        ops = old.count_ops(g, K, normal, work)
        out[f"{name}_digest"] = np.array(digest(g, K, normal))
        for n, t in zip(NAMES, got):
            out[f"{name}_{n}"] = t.numpy()
        out[f"{name}_sq"] = sq.numpy()
        out[f"{name}_chi2"] = sum_tree(sq.numpy())
        out[f"{name}_ops_jac"] = np.array(
            [ops["slam_edge_terms"][k] for k in KINDS], np.int64)
        out[f"{name}_ops_chi2"] = np.array(
            [ops["slam_chi2"][k] for k in KINDS], np.int64)
    np.savez_compressed(STORE, **out)
    print(f"wrote {STORE}: " + ", ".join(
        f"{n} chi2 {float(out[n + '_chi2']):.9g}" for n in GRAPHS))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1:])
