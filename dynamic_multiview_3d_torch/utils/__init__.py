"""Shared utilities (port of utils/): profiling, debugging, a PNG writer."""

from dynamic_multiview_3d_torch.utils.debugging import debug_mode
from dynamic_multiview_3d_torch.utils.png import write_png
from dynamic_multiview_3d_torch.utils.profiling import TraceWindow

__all__ = ["TraceWindow", "debug_mode", "write_png"]
