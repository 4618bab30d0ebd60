"""PyTorch / CUDA port of ``diff_gaussian_rasterization_tpu``.

The JAX package stays beside it as the reference.  This package imports
``torch`` and numpy only, never JAX or the JAX package.  Entry points that
create tensors default to ``device="cuda"``; functions that take tensors
run where the tensors are (the CUDA kernels on the card, their plain
PyTorch versions on the CPU).

Two API levels, as in the JAX package:

- **Native**: ``rasterize``, ``Camera``, ``RasterConfig`` (and
  ``models.gaussians.GaussianModel``).
- **Reference-style**: ``GaussianRasterizationSettings`` /
  ``GaussianRasterizer`` / ``rasterize_gaussians`` (``api.py``), the
  surface CG-SLAM-style callers use, with ``loss.backward()`` reaching
  every input, the view matrix and ``means2D`` included.
"""

from .api import (GaussianRasterizationSettings, GaussianRasterizer,
                  rasterize_gaussians)
from .camera import Camera, look_at, perspective_matrix
from .config import DEFAULT_CONFIG, RasterConfig
from .ops.oracle import RenderOutputs, render_oracle
from .ops.projection import mark_visible
from .ops.rasterize import count_instances, rasterize

__all__ = ["Camera", "DEFAULT_CONFIG", "GaussianRasterizationSettings",
           "GaussianRasterizer", "RasterConfig", "RenderOutputs",
           "count_instances", "look_at", "mark_visible",
           "perspective_matrix", "rasterize", "rasterize_gaussians",
           "render_oracle"]
