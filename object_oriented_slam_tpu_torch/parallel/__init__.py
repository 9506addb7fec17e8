"""The distributed backends on ``torch.distributed`` (port of
``object_oriented_slam_tpu/parallel``): the observation-sharded mapping
LM, the edge- and frame-sharded SLAM solve, process groups and meshes."""
from .collectives import Mesh  # noqa: F401
from .dist_lm import optimize_objects_sharded  # noqa: F401
