"""object_oriented_slam_tpu_torch: the PyTorch + CUDA port of
``object_oriented_slam_tpu``.

Same subpackages, module names, public functions and argument layouts as
the JAX package, which stays the reference the port is tested against.
Plain tensor code is PyTorch on whatever device its tensors live on; the
bundle-adjustment edge work runs in hand-written CUDA kernels
(``csrc/ba_edges.cu``) when the tensors are on a CUDA device.  This slice
covers the 2D-only online mapping loop (``system.System`` without an
extractor).
"""

__version__ = "0.1.0"
