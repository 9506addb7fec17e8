"""The JAX package's sharded solvers on tests/test_torch_dist.py's inputs.

    python tests/torch_dist_jax.py

writes tests/torch_dist_jax.npz: the inputs (``in_*``) and JAX's
``optimize_objects_sharded`` on
tests/test_dist_lm.py's ``make_workload`` and ``optimize_slam_sharded``
(dense and banded, ``shard_solve`` off and on) on tests/test_slam_ba.py's
``build_graph`` (a fresh draw of its seed), each on a two-device virtual
mesh of the CPU.  Their shard_map programs take ~4 min (the LM) and
~70-80 s (each SLAM variant) to trace and compile on the CPU, so the
quick tier compares the port with these stored results, and the slow case
``test_torch_dist.py::test_stored_results_are_jax_sharded_solvers`` runs
JAX again and holds it to them.  ``load_store`` refuses a store whose
inputs are not the workloads' of today (run this script again).  ~10 min.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
STORE = os.path.join(HERE, "torch_dist_jax.npz")
WORLD = 2
SLAM_VARIANTS = [(banded, shard_solve) for banded in (False, True)
                 for shard_solve in (False, True)]
LM_CFG = dict(gravity_on=True, gravity_scale=10.0)
SLAM_ITERS = 8


def inputs():
    """The workloads as numpy arrays: K, the LM's ("lm_*") and the SLAM
    graph's ("slam_*": 12 frames, 2 objects)."""
    import numpy as np

    import test_slam_ba
    from test_dist_lm import make_workload
    from test_svd_init import K

    _, obs = make_workload()
    rng = test_slam_ba.RNG
    test_slam_ba.RNG = np.random.default_rng(13)
    try:
        g = test_slam_ba.build_graph()[0]
    finally:
        test_slam_ba.RNG = rng
    out = {"K": K, "lm_normal": np.array([0, 0, 1], np.float32)}
    out.update({"lm_" + k: np.asarray(v) for k, v in obs._asdict().items()})
    out.update({"slam_" + k: np.asarray(v) for k, v in g._asdict().items()})
    return out


def load_store(arrays):
    """The stored JAX results by name; raises where the store was made
    from other inputs than ``arrays`` (``inputs()``)."""
    import numpy as np
    stored = dict(np.load(STORE))
    kept = {k[3:]: stored.pop(k) for k in list(stored) if k.startswith("in_")}
    stale = sorted(k for k in set(kept) | set(arrays)
                   if k not in kept or k not in arrays
                   or kept[k].dtype != arrays[k].dtype
                   or not np.array_equal(kept[k], arrays[k]))
    if stale:
        raise AssertionError(
            f"{STORE} was made from other inputs ({stale} differ): run "
            f"python tests/torch_dist_jax.py to store JAX's results anew")
    return stored


def jax_sharded(arrays):
    """JAX's sharded LM estimates and sharded SLAM poses / objects on the
    arrays of ``inputs()``, by name."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from object_oriented_slam_tpu.backend import ObjectObservations
    from object_oriented_slam_tpu.backend.lm import LMConfig
    from object_oriented_slam_tpu.backend.slam_ba import SlamGraph
    from object_oriented_slam_tpu.parallel import dist_slam
    from object_oriented_slam_tpu.parallel import optimize_objects_sharded

    def mesh(axis):
        return Mesh(np.array(jax.devices()[:WORLD]), (axis,))

    K = jnp.asarray(arrays["K"])
    obs = ObjectObservations(**{k: jnp.asarray(arrays["lm_" + k])
                                for k in ObjectObservations._fields})
    out = {"lm_est": np.asarray(optimize_objects_sharded(
        obs, K, jnp.asarray(arrays["lm_normal"]), True, mesh("obs"),
        LMConfig(**LM_CFG))[0])}
    g = SlamGraph(**{k: jnp.asarray(arrays["slam_" + k])
                     for k in SlamGraph._fields})
    for banded, shard_solve in SLAM_VARIANTS:
        poses, objs, _ = dist_slam.optimize_slam_sharded(
            g, K, jnp.zeros(3), mesh("edge"), LMConfig(iters=SLAM_ITERS),
            shard_solve=shard_solve, banded=banded)
        key = f"slam_{int(banded)}{int(shard_solve)}"
        out[key + "_poses"] = np.asarray(poses)
        out[key + "_objects"] = np.asarray(objs)
    return out


if __name__ == "__main__":
    # tests/conftest.py's settings: the CPU, an 8-device virtual mesh
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("OSLAM_NO_COMPILE_CACHE", "1")
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") +
        " --xla_force_host_platform_device_count=8"
        " --xla_cpu_parallel_codegen_split_count=1").strip()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import numpy as np
    arrays = inputs()
    np.savez(STORE, **jax_sharded(arrays),
             **{"in_" + k: v for k, v in arrays.items()})
    print(f"wrote {STORE}")
