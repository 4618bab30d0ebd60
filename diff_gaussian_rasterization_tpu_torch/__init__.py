"""PyTorch / CUDA port of ``diff_gaussian_rasterization_tpu``.

The JAX package stays beside it as the reference.  This package imports
``torch`` and numpy only, never JAX or the JAX package.  Entry points that
create tensors default to ``device="cuda"``; functions that take tensors
run where the tensors are (the CUDA kernels on the card, their plain
PyTorch versions on the CPU).
"""

from .camera import Camera, look_at, perspective_matrix
from .config import DEFAULT_CONFIG, RasterConfig
from .ops.rasterize import count_instances, rasterize

__all__ = ["Camera", "DEFAULT_CONFIG", "RasterConfig", "count_instances",
           "look_at", "perspective_matrix", "rasterize"]
