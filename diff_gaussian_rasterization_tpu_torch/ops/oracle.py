"""Render outputs (PyTorch port of the JAX package's ``ops/oracle.py``).

Only the output record is ported so far; the brute-force oracle renderer
``render_oracle`` comes with the backward slice, where it is the ground
truth for gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOutputs(NamedTuple):
    """The light variant's 8 forward outputs plus diagnostics."""

    color: torch.Tensor            # (3, H, W)
    radii: torch.Tensor            # (P,) int32
    depth: torch.Tensor            # (1, H, W)  sum d * alpha * T
    depth_median: torch.Tensor     # (1, H, W)
    depth_var: torch.Tensor        # (1, H, W)  zeros when cfg.ref_depth_var
    opacity_map: torch.Tensor      # (1, H, W)  sum alpha * T (silhouette)
    gau_uncertainty: torch.Tensor  # (P, 1)
    gau_related_pixels: torch.Tensor  # (P, 1) int32
    n_contrib: torch.Tensor        # (H, W) int32 (last contributor)
    n_valid: torch.Tensor          # (H, W) int32 (number of contributors)
    num_rendered: torch.Tensor     # () int64: true (gaussian, tile) pairs
    overflow: torch.Tensor         # () bool: instance budget exceeded
