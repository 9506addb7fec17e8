"""object_oriented_slam_tpu_torch: the PyTorch + CUDA port of
``object_oriented_slam_tpu``.

Same subpackages, module names, public functions and argument layouts as
the JAX package, which stays the reference the port is tested against.
Plain tensor code is PyTorch on whatever device its tensors live on; the
bundle-adjustment edge work (``csrc/ba_edges.cu``) and the extraction's
back-projection, voxel means and clustering rounds (``csrc/frontend.cu``)
run in hand-written CUDA kernels when the tensors are on a CUDA device.
Ported so far: the online mapping loop (``system.System``) with the deferred
frame pipeline, 2D-only or with depth (ground plane, monolithic extraction
with symmetry, 3D observations), and its TUM command line
(``examples/torch_run_tum.py`` over ``io.tum``).
"""

__version__ = "0.1.0"
