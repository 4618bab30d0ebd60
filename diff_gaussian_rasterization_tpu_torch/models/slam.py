"""SLAM-level helpers (PyTorch port of the JAX package's ``models/slam.py``).

Only the render wrapper is ported so far; tracking and mapping come with
the backward and pose-JVP slices.
"""

from __future__ import annotations

from ..camera import Camera
from ..config import RasterConfig
from ..ops.rasterize import rasterize
from .gaussians import GaussianModel


def render_model(model: GaussianModel, camera: Camera, cfg: RasterConfig,
                 gt_depth=None, means2D=None, **kw):
    """Render a :class:`GaussianModel` from ``camera``."""
    return rasterize(model.means3D, camera, cfg, gt_depth=gt_depth,
                     means2D=means2D, **model.raster_kwargs(), **kw)
