"""The port runs where JAX is not installed: every module of
object_oriented_slam_tpu_torch imports with ``jax`` blocked, and none of
its sources imports JAX or the JAX package."""
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
print(len(names))
"""


def _sources():
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|object_oriented_slam_tpu)\b",
                     re.M)
    bad = [p for p in _sources() if pat.search(open(p).read())]
    assert not bad, bad
