"""Render outputs, and the dense oracle renderer (PyTorch port of the JAX
package's ``ops/oracle.py``).

``render_oracle`` is small and slow by design: every pixel considers every
Gaussian in global depth order, by default with a per-pixel
tile-membership mask that makes its output comparable to the tiled render
op.  It is plain PyTorch,
so autograd through it is the ground truth that the analytic backward of
``ops/rasterize.py`` is held to, for every parameter and the view matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera import Camera
from ..config import RasterConfig
from . import blend
from .kernels.segment_sum import scatter_sum
from .projection import preprocess


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


def render_oracle(means3D, camera: Camera, cfg: RasterConfig = None, *,
                  opacities, scales=None, rotations=None, cov3D_precomp=None,
                  shs=None, sh_degree: int = 0, colors_precomp=None,
                  scale_modifier: float = 1.0, bg=None, gt_depth=None,
                  tile_mask: bool = True,
                  pixel_chunk: int = 8192) -> RenderOutputs:
    """Render with O(P * pixels) brute force, ``pixel_chunk`` pixels at a
    time.  With ``tile_mask`` (the default) each pixel sees the Gaussians
    whose tile rectangle covers its tile, as the binning does; without it,
    every pixel sees every visible Gaussian (the JAX version's
    ``tile_mask`` either way).  ``n_contrib`` is the 1-based position of
    the last contributor in the global depth order."""
    cfg = RasterConfig() if cfg is None else cfg
    h, w = camera.height, camera.width
    p = means3D.shape[0]
    dtype, dev = means3D.dtype, means3D.device
    if bg is None:
        bg = torch.zeros(3, dtype=dtype, device=dev)
    if gt_depth is None:
        gt_depth = torch.zeros((h, w), dtype=dtype, device=dev)
    gt_all = gt_depth.reshape(-1)

    prep = preprocess(
        means3D, camera, cfg, opacities=opacities, scales=scales,
        rotations=rotations, cov3D_precomp=cov3D_precomp, shs=shs,
        sh_degree=sh_degree, colors_precomp=colors_precomp,
        scale_modifier=scale_modifier)

    # global front-to-back order (the sort itself is not differentiable)
    sort_key = torch.where(prep.mask, prep.depth.detach(),
                           torch.full_like(prep.depth, float("inf")))
    order = torch.sort(sort_key, stable=True).indices
    xy, conic, opacity = prep.xy[order], prep.conic[order], \
        prep.opacity[order]
    color, depth = prep.color[order], prep.depth[order]
    depth_med = prep.depth_sgview[order]
    valid_g = prep.mask[order]
    rect_min, rect_max = prep.rect_min[order], prep.rect_max[order]

    px_all = torch.arange(w, dtype=dtype, device=dev).repeat(h)
    py_all = torch.arange(h, dtype=dtype, device=dev).repeat_interleave(w)
    parts = []
    for q0 in range(0, h * w, pixel_chunk):
        px = px_all[q0:q0 + pixel_chunk]
        py = py_all[q0:q0 + pixel_chunk]
        if tile_mask:
            tx = torch.floor(px / cfg.tile_w).to(torch.int32)[None, :]
            ty = torch.floor(py / cfg.tile_h).to(torch.int32)[None, :]
            valid = (valid_g[:, None]
                     & (rect_min[:, 0:1] <= tx) & (tx < rect_max[:, 0:1])
                     & (rect_min[:, 1:2] <= ty) & (ty < rect_max[:, 1:2]))
        else:
            valid = valid_g
        carry = blend.init_carry(px.shape, 3, dtype, dev)
        carry = blend.blend_chunk_fwd(
            carry, xy, conic, opacity, color, depth, depth_med, valid, px,
            py, 0, cfg)
        gt = gt_all[q0:q0 + pixel_chunk]
        parts.append(carry._replace(var_dd=blend.finish_var(carry, gt),
                                    ucross_dd=blend.finish_ucross(carry, gt)))
    c = blend.BlendCarry(*(torch.cat(x, dim=-1) for x in zip(*parts)))

    img = lambda x: x.reshape(h, w)
    color_img = c.color.reshape(3, h, w) + img(c.t_final)[None] \
        * bg[:, None, None]
    depth_var = img(c.var_dd)
    if cfg.ref_depth_var:
        # value 0 like the reference forward; the true variance's gradient
        depth_var = depth_var - depth_var.detach()
    # per-Gaussian median-crossing statistics, keyed by the crossing's
    # Gaussian (midx indexes the depth order)
    keys = torch.where(c.midx >= 0,
                       order[c.midx.clamp_min(0).to(torch.int64)],
                       torch.full_like(order[:1], -1))
    gau_u, gau_npix = scatter_sum(keys, c.ucross_dd.detach(),
                                  torch.ones_like(c.midx), p)
    return RenderOutputs(
        color=color_img,
        radii=prep.radius,
        depth=img(c.depth)[None],
        depth_median=img(c.median)[None],
        depth_var=depth_var[None],
        opacity_map=img(c.weight)[None],
        gau_uncertainty=gau_u[:, None],
        gau_related_pixels=gau_npix[:, None],
        n_contrib=img(c.n_contrib),
        n_valid=img(c.n_valid),
        num_rendered=prep.tiles_touched.to(torch.int64).sum(),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )
