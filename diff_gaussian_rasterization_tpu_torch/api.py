"""The reference-style API (PyTorch port of the JAX package's ``__init__.py``
compatibility surface and of the contract of its ``torch_compat.py``).

CG-SLAM and the other callers of the modelled CUDA rasterizer reach it
through ``GaussianRasterizationSettings`` / ``GaussianRasterizer`` and
``loss.backward()``: they read gradients off every input, the view matrix
(the pose gradient) and the screen-space ``means2D`` placeholder (the
densification statistic) included.  Here that surface sits on
:func:`~.ops.rasterize.rasterize`.

``rasterize_gaussians`` is one ``torch.autograd.Function``, as the
reference's ``_RasterizeGaussians`` is one.  Its forward runs ``rasterize``
on detached copies of the inputs with autograd on and keeps that graph; its
backward runs ``torch.autograd.grad`` through it with the reference's
cotangent set.  So the kernels launched and every output and gradient are
``rasterize``'s own, and the backward has one place for the two things the
reference does there:

- ``alpha_grad=False`` (the default) drops the ``opacity_map`` cotangent,
  as the reference's autograd.Function never passes it to its CUDA
  backward; the ``depth_median`` and ``depth_var`` cotangents still flow;
- ``debug=True`` checks the forward's images and the backward's gradients
  for non-finite values, and on a failure writes ``snapshot_fw.dump`` /
  ``snapshot_bw.dump`` (a pickle of numpy host copies of the inputs; the
  backward's with the ``cotangents``) and raises ``FloatingPointError``.

Only ``debug`` and ``prefiltered`` read a value back to the host.
"""

from __future__ import annotations

import contextlib
import pickle
from typing import Any, NamedTuple

import numpy as np
import torch

from .camera import Camera
from .config import DEFAULT_CONFIG, RasterConfig
from .ops.projection import mark_visible
from .ops.rasterize import rasterize

# the differentiable inputs, in the order of the autograd.Function's
_INPUTS = ("means3D", "means2D", "shs", "colors_precomp", "opacities",
           "scales", "rotations", "cov3D_precomp", "viewmatrix")
# the light variant's outputs (light __init__.py:105), and which of them
# carry a cotangent into the backward
_OUTPUTS = ("color", "radii", "depth", "depth_median", "depth_var",
            "opacity_map", "gau_uncertainty", "gau_related_pixels")
_DIFF_OUTPUTS = ("color", "depth", "depth_median", "depth_var",
                 "opacity_map")


class GaussianRasterizationSettings(NamedTuple):
    """The reference's settings tuple (light ``__init__.py:180-195``).

    ``projmatrix``, ``perspec_matrix`` and ``campos`` are accepted and
    ignored: the render derives them from the live view matrix, so the
    pose gradient is exact.
    """

    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    bg: Any
    scale_modifier: float
    viewmatrix: Any
    projmatrix: Any = None
    sh_degree: int = 0
    campos: Any = None
    prefiltered: bool = False
    debug: bool = False
    perspec_matrix: Any = None
    track_off: bool = False
    map_off: bool = False


class GaussianRasterizer:
    """The reference's ``GaussianRasterizer`` (light ``__init__.py:197-248``;
    the full package's ``__init__.py:167-218`` with ``variant="full"``).

    ``variant="light"`` returns the 8-tuple ``(color, radii, depth,
    depth_median, depth_var, opacity_map, gau_uncertainty,
    gau_related_pixels)``; ``variant="full"`` renders with
    ``config.full_variant()`` (the SH and 2D-covariance pose branches) and
    returns the full package's ``(color, radii, depth, uncertainty)``, whose
    "uncertainty" image is the silhouette (full ``forward.cu:367,394``).
    ``alpha_grad`` as in :func:`rasterize_gaussians`.
    """

    def __init__(self, raster_settings: GaussianRasterizationSettings,
                 config: RasterConfig = DEFAULT_CONFIG,
                 variant: str = "light", alpha_grad: bool = False):
        if variant == "full":
            config = config.full_variant()
        self.variant = variant
        self.raster_settings = raster_settings
        self.config = config
        self.alpha_grad = alpha_grad

    def markVisible(self, positions):
        """The near-plane test against the settings' view matrix (light
        ``__init__.py:202-211``)."""
        view = self.raster_settings.viewmatrix
        positions = _as_tensor(positions, view)
        with torch.no_grad():
            return mark_visible(positions, _as_tensor(view, positions),
                                near=self.config.near)

    def __call__(self, *a, **k):
        return self.forward(*a, **k)

    def forward(self, means3D, means2D=None, opacities=None, shs=None,
                colors_precomp=None, scales=None, rotations=None,
                cov3D_precomp=None, viewmatrix=None, gt_depth=None):
        if (shs is None) == (colors_precomp is None):
            raise ValueError(
                "Please provide exactly one of either SHs or precomputed "
                "colors!")
        if ((scales is None or rotations is None)
                and cov3D_precomp is None) or (
                (scales is not None or rotations is not None)
                and cov3D_precomp is not None):
            raise ValueError(
                "Please provide exactly one of either scale/rotation pair "
                "or precomputed 3D covariance!")
        out = rasterize_gaussians(
            means3D=means3D, means2D=means2D, shs=shs,
            colors_precomp=colors_precomp, opacities=opacities,
            scales=scales, rotations=rotations, cov3Ds_precomp=cov3D_precomp,
            viewmatrix=viewmatrix, gt_depth=gt_depth,
            raster_settings=self.raster_settings, config=self.config,
            alpha_grad=self.alpha_grad)
        if self.variant == "full":
            return out[0], out[1], out[2], out[5]
        return out


def _as_tensor(x, like=None):
    """``x`` as a tensor: an empty one (the reference's ``torch.Tensor([])``
    placeholder) as None, a numpy array on ``like``'s device (``cuda``
    without one) in ``like``'s floating dtype (float32 without one)."""
    if x is None:
        return None
    if not torch.is_tensor(x):
        like = like if torch.is_tensor(like) else None
        x = np.asarray(x)
        dtype = None
        if np.issubdtype(x.dtype, np.floating):
            dtype = like.dtype if like is not None else torch.float32
        x = torch.as_tensor(x, dtype=dtype,
                            device=like.device if like is not None
                            else "cuda")
    return None if x.numel() == 0 else x


def _host(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items() if v is not None}
    return x


@contextlib.contextmanager
def _dump_on_error(debug: bool, stage: str, path: str, inputs):
    """With ``debug``, an exception leaving the block first writes
    ``path``: a pickle of numpy host copies of ``inputs()`` (light
    ``__init__.py:90-97, 149-158``)."""
    try:
        yield
    except Exception:
        if debug:
            with open(path, "wb") as f:
                pickle.dump({k: _host(v) for k, v in inputs().items()}, f)
            print(f"\nAn error occurred in the rasterizer {stage}. Inputs "
                  f"written to {path} for debugging.")
        raise


def _check_finite(tensors: dict, what: str):
    bad = [n for n, t in tensors.items()
           if t is not None and not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(f"non-finite {what}: {bad}")


def _check_prefiltered(means3D, viewmatrix, cfg: RasterConfig):
    """``auxiliary.h:156-160``: with ``prefiltered=True`` every Gaussian
    must pass the frustum test; the reference traps, unconditionally."""
    with torch.no_grad():
        n_bad = int((~mark_visible(means3D, viewmatrix,
                                   near=cfg.near)).sum())
    if n_bad:
        raise RuntimeError(
            f"prefiltered=True but {n_bad} Gaussians fail the frustum "
            "test (the reference traps here: auxiliary.h:156-160)")


class _RasterizeGaussians(torch.autograd.Function):
    """``rasterize`` with the reference's gradient surface (see the module
    docstring).  ``render(*leaves)`` renders the inputs of ``_INPUTS``;
    ``snapshot()`` names what a debug dump holds."""

    @staticmethod
    def forward(ctx, render, snapshot, debug, grad, alpha_grad, *inputs):
        leaves = [None if x is None
                  else x.detach().requires_grad_(grad and x.requires_grad)
                  for x in inputs]
        with _dump_on_error(debug, "forward", "snapshot_fw.dump", snapshot):
            with torch.enable_grad():
                out = render(*leaves)
            if debug:
                _check_finite({n: getattr(out, n) for n in
                               ("color", "depth", "opacity_map")},
                              "render outputs")
        outs = tuple(getattr(out, n) for n in _OUTPUTS)
        ctx.set_materialize_grads(False)
        ctx.leaves, ctx.outs = leaves, outs
        ctx.debug, ctx.alpha_grad, ctx.snapshot = debug, alpha_grad, snapshot
        res = tuple(o.detach() for o in outs)
        ctx.mark_non_differentiable(res[1], res[6], res[7])
        return res

    @staticmethod
    def backward(ctx, d_color, _d_radii, d_depth, d_median, d_var, d_alpha,
                 _d_u, _d_np):
        if not ctx.alpha_grad:
            d_alpha = None
        outs = dict(zip(_OUTPUTS, ctx.outs))
        cots = dict(zip(_DIFF_OUTPUTS,
                        (d_color, d_depth, d_median, d_var, d_alpha)))
        pairs = [(outs[n], c) for n, c in cots.items()
                 if c is not None and outs[n].requires_grad]
        want = [i for i, x in enumerate(ctx.leaves)
                if x is not None and x.requires_grad]
        grads = [None] * len(ctx.leaves)
        snapshot = lambda: {**ctx.snapshot(), "cotangents": {
            n: torch.zeros_like(outs[n]) if c is None else c
            for n, c in cots.items()}}
        with _dump_on_error(ctx.debug, "backward", "snapshot_bw.dump",
                            snapshot):
            if pairs and want:
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [ctx.leaves[i] for i in want],
                    [c for _, c in pairs], allow_unused=True)
                for i, g in zip(want, got):
                    grads[i] = g
            if ctx.debug:
                _check_finite(dict(zip(_INPUTS, grads)), "gradients")
        return (None,) * 5 + tuple(grads)


def rasterize_gaussians(means3D, shs=None, colors_precomp=None,
                        opacities=None, scales=None, rotations=None,
                        cov3Ds_precomp=None, viewmatrix=None, gt_depth=None,
                        raster_settings: GaussianRasterizationSettings = None,
                        config: RasterConfig = DEFAULT_CONFIG, means2D=None,
                        alpha_grad: bool = False):
    """The reference's ``rasterize_gaussians`` (light ``__init__.py:21-46``):
    the light variant's 8-tuple ``(color, radii, depth, depth_median,
    depth_var, opacity_map, gau_uncertainty, gau_related_pixels)``.

    ``loss.backward()`` gives a gradient to every input that requires one:
    the Gaussians' parameters, ``viewmatrix`` [4, 4] (the settings' view
    matrix unless one is passed) and ``means2D``, the reference's [P, 3]
    screen-space placeholder, whose gradient is the NDC position gradient
    in its first two columns and zero in the third.  ``radii``,
    ``gau_uncertainty`` and ``gau_related_pixels`` carry none.
    ``alpha_grad=False`` drops the ``opacity_map`` cotangent, as the
    reference does; ``True`` keeps it.  Empty tensors count as absent;
    numpy inputs go to the device of ``means3D`` (``cuda`` when it is numpy
    too).  ``track_off`` / ``map_off`` come from the settings.
    """
    s = raster_settings
    m = _as_tensor(means3D)
    view = _as_tensor(viewmatrix if viewmatrix is not None else s.viewmatrix,
                      m)
    inputs = dict(
        means3D=m, means2D=_as_tensor(means2D, m), shs=_as_tensor(shs, m),
        colors_precomp=_as_tensor(colors_precomp, m),
        opacities=_as_tensor(opacities, m), scales=_as_tensor(scales, m),
        rotations=_as_tensor(rotations, m),
        cov3D_precomp=_as_tensor(cov3Ds_precomp, m), viewmatrix=view)
    bg, gt = _as_tensor(s.bg, m), _as_tensor(gt_depth, m)
    h, w = int(s.image_height), int(s.image_width)

    def render(means3D, means2D, shs, colors_precomp, opacities, scales,
               rotations, cov3D_precomp, viewmatrix):
        cam = Camera(viewmatrix=viewmatrix, tanfovx=float(s.tanfovx),
                     tanfovy=float(s.tanfovy), height=h, width=w)
        return rasterize(
            means3D, cam, config, opacities=opacities, scales=scales,
            rotations=rotations, cov3D_precomp=cov3D_precomp, shs=shs,
            sh_degree=int(s.sh_degree), colors_precomp=colors_precomp,
            scale_modifier=float(s.scale_modifier), bg=bg, gt_depth=gt,
            means2D=None if means2D is None else means2D[:, :2],
            track_off=bool(s.track_off), map_off=bool(s.map_off))

    snapshot = lambda: dict(settings=s._asdict(), bg=bg, gt_depth=gt, **{
        k: v for k, v in inputs.items() if v is not None})
    with _dump_on_error(s.debug, "forward", "snapshot_fw.dump", snapshot):
        if s.prefiltered:
            _check_prefiltered(m, view, config)
    return _RasterizeGaussians.apply(render, snapshot, bool(s.debug),
                                     torch.is_grad_enabled(), alpha_grad,
                                     *inputs.values())
