"""The port runs where JAX is not installed: every module of
object_oriented_slam_tpu_torch imports with ``jax`` blocked, and none of
its sources (Python and CUDA), nor chip_smoke.py, nor the port's example
scripts, imports or names JAX or the JAX package's modules."""
import os
import re
import subprocess
import sys

import object_oriented_slam_tpu_torch

PKG_DIR = os.path.dirname(object_oriented_slam_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "object_oriented_slam_tpu"):
    sys.modules[name] = None          # any import of these raises
import object_oriented_slam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
"""

# the depth slice's modules, each of which must be among those imported
DEPTH_MODULES = ["core.plane", "ops._cuda_build", "ops.frontend_kernels",
                 "ops.backproject", "ops.voxel", "ops.cluster", "ops.pca",
                 "ops.linalg", "frontend", "frontend.ground_plane",
                 "frontend.extractor", "frontend.symmetry",
                 "frontend.batch_extractor", "io.synthetic",
                 "system.tracking", "system.offline",
                 "system.system", "system.checkpoint", "backend.ba_kernels",
                 "io.png", "io.tum", "io.native_loader", "utils.transfer",
                 "backend.residuals", "backend.slam_ba",
                 "backend.slam_kernels", "system.slam_mode",
                 "utils.device", "parallel", "parallel.collectives",
                 "parallel.multihost", "parallel.dist_lm",
                 "parallel.dist_slam", "parallel.dryrun",
                 "init", "init.svd_init", "backend.lm", "utils.measurement",
                 "system.profiling", "system.dense_builder",
                 "ops.dense_fuse", "viz", "viz.export", "viz.web_viewer"]


def _sources():
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 30
    for mod in DEPTH_MODULES:
        assert "object_oriented_slam_tpu_torch." + mod in names, mod


_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|object_oriented_slam_tpu)\b", re.M)


def test_no_source_imports_jax():
    bad = [p for p in _sources() if _IMPORT.search(open(p).read())]
    assert not bad, bad


def _scripts():
    yield os.path.join(ROOT, "chip_smoke.py")
    # the rank processes of the port's two-rank gloo tests, and the mesh
    # tests that also run on the card
    yield os.path.join(ROOT, "tests", "_torch_dist_worker.py")
    yield os.path.join(ROOT, "tests", "test_torch_multihost.py")
    ex = os.path.join(ROOT, "examples")
    for f in sorted(os.listdir(ex)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(ex, f)


def test_chip_smoke_and_port_examples_import_no_jax():
    """chip_smoke.py (every phase, the depth ones included), the
    examples/torch_*.py scripts, tests/_torch_dist_worker.py and
    tests/test_torch_multihost.py import the port and never JAX;
    importing chip_smoke with JAX blocked works and starts nothing."""
    scripts = list(_scripts())
    assert len(scripts) >= 2
    names = [os.path.basename(p) for p in scripts]
    assert "torch_run_tum.py" in names and \
        "torch_make_synthetic_tum.py" in names
    for p in scripts:
        src = open(p).read()
        assert not _IMPORT.search(src), p
        assert not re.search(r"import_module\(\s*[\"']jax", src), p
    code = ("import sys\n"
            "for n in ('jax', 'jaxlib', 'object_oriented_slam_tpu'):\n"
            "    sys.modules[n] = None\n"
            "import chip_smoke\n"
            "print(sorted(n for n in dir(chip_smoke) if n.startswith('phase_')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for phase in ("phase_kernels", "phase_steps", "phase_whole_lm",
                  "phase_main_path", "phase_frontend_kernels",
                  "phase_depth_path", "phase_symmetry_path",
                  "phase_symmetry_kernel", "phase_cli", "phase_offline",
                  "phase_slam", "phase_dist"):
        assert phase in out.stdout, phase


def test_cuda_sources_are_in_the_package():
    """Every kernel source the wrappers build ships inside the package."""
    from object_oriented_slam_tpu_torch.backend import (ba_kernels,
                                                        slam_kernels)
    from object_oriented_slam_tpu_torch.ops import frontend_kernels
    for mod in (ba_kernels, frontend_kernels, slam_kernels):
        assert os.path.isfile(mod.SOURCE), mod.SOURCE
        assert os.path.samefile(os.path.dirname(mod.SOURCE),
                                os.path.join(PKG_DIR, "csrc"))
