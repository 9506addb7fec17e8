"""Headless renders and the standalone web viewer (port of the JAX
package's ``viz``)."""
from .export import draw_depth_frame, draw_frame, render_map  # noqa: F401
