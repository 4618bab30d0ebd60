"""Rasterizer configuration (PyTorch port).

A field-for-field copy of the JAX package's ``RasterConfig`` so that a
configuration carries across one to one.  It is copied, not imported:
importing the JAX package's module runs that package's ``__init__``, which
imports JAX.

Fields that steer only the TPU kernels and have no effect in this port:

- ``scan_sum_mm`` / ``scan_prod_mm``: run the blend's prefix scans on the
  TPU matrix unit.  The CUDA kernel blends each pixel sequentially and the
  plain version uses ``torch.cumprod``; neither has a scan to move.
- ``bwd_scan_sum_mm``, ``bwd_scan_prod_mm``, ``bwd_chunk``: per-pass
  overrides for the TPU backward kernel.
- ``kernel_tile_batch``: tiles per Pallas grid step.  The CUDA kernel runs
  one thread block per tile.
- ``bin_row_gather``: a choice between two TPU formulations of the binning
  expansion; the port has one expansion whose output is identical to both.

``splat_basis_power=True`` takes the splat exponent in the JAX package's
basis form: the quadratic expanded about each tile's corner, six
coefficients a splat against the tile-local pixel basis ``[1, x, y, x^2,
y^2, x y]``.  On the TPU that made it a matrix-unit contraction; here the
plain versions and the CUDA kernels' basis instantiations sum it in one
fixed order (``ops/blend.py``).  It changes alpha by about 1e-4 relative;
the dual render (``rasterize_with_pose_jvp``, tracking) refuses it, as the
JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static configuration of the rasterizer.

    The numerical constants mirror the reference kernels exactly:
    ``alpha_cap`` / ``alpha_min`` / ``t_terminate`` (forward.cu:364-373),
    ``lowpass`` (forward.cu:110-111), ``radius_sigma`` / ``eig_clamp``
    (forward.cu:229-232), ``near`` (auxiliary.h:154), ``fov_clamp``
    (forward.cu:82-87) and ``w_eps`` (forward.cu:199).
    """

    # --- tiling ---
    tile_h: int = 32
    tile_w: int = 32

    # --- blend thresholds (exact reference semantics) ---
    alpha_cap: float = 0.99
    alpha_min: float = 15.0 / 255.0
    t_terminate: float = 1e-4

    # --- projection / footprint ---
    lowpass: float = 0.3
    radius_sigma: float = 3.0
    eig_clamp: float = 0.1
    near: float = 0.2
    fov_clamp: float = 1.3
    w_eps: float = 1e-7

    # Bin each splat with its exact alpha_min footprint instead of the
    # reference's fixed 3-sigma rect: identical output, fewer instances.
    opacity_cull: bool = True
    # Extra pixels of binning footprint around every live splat.
    bin_margin_px: float = 0.0
    # TPU knob (see the module docstring): no effect in the port.
    bin_row_gather: bool = False

    # --- parity quirks ---
    # The reference uses quaternions unnormalized (forward.cu:127).
    normalize_quaternions: bool = False
    # True: the forward depth-variance image is zero like the reference's
    # (forward.cu:317,410); False: the real per-pixel variance.
    ref_depth_var: bool = True

    # --- pose-gradient branches (full vs light variant) ---
    pose_ndc_branch: bool = True
    pose_depth_branch: bool = True
    pose_cov2d_branch: bool = False
    pose_sh_branch: bool = False

    # --- capacity: the static instance budget; overflow is reported ---
    max_instances: Optional[int] = None
    instance_multiplier: int = 8  # used when max_instances is None

    # The splat exponent in the basis form about each tile's corner (see the
    # module docstring): the forward and backward blends, not the dual one.
    splat_basis_power: bool = False

    # TPU knobs (see the module docstring): no effect in the port.
    scan_sum_mm: bool = False
    scan_prod_mm: bool = False
    bwd_scan_sum_mm: Optional[bool] = None
    bwd_scan_prod_mm: Optional[bool] = None
    bwd_chunk: Optional[int] = None

    # --- backend selection (kept for configs that carry across; the port
    # picks its path from the tensors' device) ---
    backend: str = "auto"
    # instances per chunk of the plain blend's prefix product
    chunk: int = 128
    # TPU knob (see the module docstring): no effect in the port.
    kernel_tile_batch: int = 1

    def __post_init__(self):
        # alpha <= alpha_cap < 1 keeps the backward's 1/(1-alpha) finite
        if not (0.0 < self.alpha_cap < 1.0):
            raise ValueError(
                f"alpha_cap must be in (0, 1), got {self.alpha_cap}")
        if not (0.0 < self.alpha_min < 1.0):
            raise ValueError(
                f"alpha_min must be in (0, 1), got {self.alpha_min}")

    def replace(self, **kw) -> "RasterConfig":
        return dataclasses.replace(self, **kw)

    @property
    def tile_px(self) -> int:
        return self.tile_h * self.tile_w

    def full_variant(self) -> "RasterConfig":
        """Pose Jacobian with all branches (the reference 'full' package)."""
        return self.replace(pose_cov2d_branch=True, pose_sh_branch=True)


DEFAULT_CONFIG = RasterConfig()
