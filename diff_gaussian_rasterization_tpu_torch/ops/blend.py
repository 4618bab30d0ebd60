"""Front-to-back alpha blending as masked prefix products, and its VJP.

PyTorch port of the JAX package's ``ops/blend.py`` (direct splat form
only).  Per pixel, instances sorted front to back:

- ``a_i = 1 - alpha_i`` where the instance passes the validity tests
  (``power <= 0`` and ``alpha >= alpha_min``), else 1;
- the inclusive prefix product ``P_i = prod_{j<=i} a_j`` is the
  transmittance after instance i.  Since ``P`` never increases, stopping
  *before* accumulating once ``P_i < t_terminate`` is the mask
  ``contrib_i = valid_i & (P_i >= t_terminate)``;
- blend weights are ``w_i = alpha_i * P_{i-1} * contrib_i``, and the median
  crossing is ``contrib & (P_{i-1} > 0.5) & (P_i < 0.5)``, which fires at
  most once per pixel.

The backward (:func:`blend_chunk_bwd`) is the closed-form VJP of one chunk:
it re-derives the same weights in the same forward order and carries the
running prefix ``pre_all`` of ``w * s``, where ``s`` is an instance's
features dotted with its pixel's cotangents, so the gradient of every
alpha needs only the pixel's total and that prefix.

Every function takes any number of leading batch dimensions: instance
tensors are ``[..., G, k]``, pixel tensors ``[..., Q]``, masks and weights
``[..., G, Q]``.  The plain render core (``kernels/render.py``) runs them on
a batch of tiles at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RasterConfig


def splat_power(xy, conic, px, py):
    """Per (instance, pixel) Gaussian exponent
    ``-0.5 (A dx^2 + C dy^2) - B dx dy``, shape [..., G, Q]."""
    A, B, C = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    dx = xy[..., 0:1] - px[..., None, :]
    dy = xy[..., 1:2] - py[..., None, :]
    return -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy


def splat_alpha(xy, conic, opacity, px, py, cfg: RasterConfig):
    """alpha [..., G, Q] and ok [..., G, Q] (power <= 0 and
    alpha >= alpha_min)."""
    power = splat_power(xy, conic, px, py)
    alpha = torch.clamp_max(opacity[..., None] * torch.exp(power),
                            cfg.alpha_cap)
    ok = (power <= 0.0) & (alpha >= cfg.alpha_min)
    return alpha, ok


class BlendCarry(NamedTuple):
    """Running per-pixel state across instance chunks (all [..., Q])."""

    prod: torch.Tensor       # running product of a over valid instances
    t_final: torch.Tensor    # min of P over contributing instances
    color: torch.Tensor      # [..., C, Q] sum w * color
    depth: torch.Tensor      # sum w * depth
    weight: torch.Tensor     # sum w (the opacity map)
    median: torch.Tensor     # depth at the T = 0.5 crossing (0 if none)
    var_dd: torch.Tensor     # sum w * d^2   (raw moment; see finish_var)
    var_d: torch.Tensor      # sum w * d
    n_contrib: torch.Tensor  # int32, 1-based segment index of the last
                             # contributor
    n_valid: torch.Tensor    # int32, number of contributors
    midx: torch.Tensor       # int32, global instance index of the median
                             # crossing (-1 if none)
    ucross_dd: torch.Tensor  # sum cross * w * d^2 (see finish_ucross)
    ucross_d: torch.Tensor   # sum cross * w * d
    ucross_w: torch.Tensor   # sum cross * w


def init_carry(shape, channels: int = 3, dtype=torch.float32,
               device="cuda") -> BlendCarry:
    """The initial carry for pixel tensors of ``shape`` ([..., Q])."""
    shape = tuple(shape)
    z = lambda: torch.zeros(shape, dtype=dtype, device=device)
    ints = lambda v: torch.full(shape, v, dtype=torch.int32, device=device)
    return BlendCarry(
        prod=torch.ones(shape, dtype=dtype, device=device),
        t_final=torch.ones(shape, dtype=dtype, device=device),
        color=torch.zeros(shape[:-1] + (channels,) + shape[-1:], dtype=dtype,
                          device=device),
        depth=z(), weight=z(), median=z(), var_dd=z(), var_d=z(),
        n_contrib=ints(0), n_valid=ints(0), midx=ints(-1),
        ucross_dd=z(), ucross_d=z(), ucross_w=z(),
    )


def finish_var(carry: BlendCarry, gt):
    """sum w * (d - gt)^2 recombined from the raw moments."""
    return carry.var_dd - 2.0 * gt * carry.var_d + gt * gt * carry.weight


def finish_ucross(carry: BlendCarry, gt):
    """The median-crossing uncertainty (d - gt)^2 * alpha * T from the raw
    moments."""
    return (carry.ucross_dd - 2.0 * gt * carry.ucross_d
            + gt * gt * carry.ucross_w)


def chunk_weights(prod_in, xy, conic, opacity, valid, px, py,
                  cfg: RasterConfig):
    """Alphas, transmittances, blend weights and the median-crossing mask of
    one [..., G, Q] chunk.  ``valid`` is [..., G, Q] or [..., G].

    Returns (alpha, v, p_incl, t_excl, contrib, w, cross)."""
    alpha, ok = splat_alpha(xy, conic, opacity, px, py, cfg)
    v = (valid if valid.dim() == alpha.dim() else valid[..., None]) & ok
    a_eff = torch.where(v, 1.0 - alpha, torch.ones_like(alpha))
    p_incl = prod_in[..., None, :] * torch.cumprod(a_eff, dim=-2)
    t_excl = torch.cat([prod_in[..., None, :], p_incl[..., :-1, :]], dim=-2)
    contrib = v & (p_incl >= cfg.t_terminate)
    w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
    cross = contrib & (t_excl > 0.5) & (p_incl < 0.5)
    return alpha, v, p_incl, t_excl, contrib, w, cross


def blend_chunk_fwd(carry: BlendCarry, xy, conic, opacity, color, depth,
                    depth_med, valid, px, py, base_index, cfg: RasterConfig,
                    global_base=None) -> BlendCarry:
    """Blend one front-to-back chunk of instances into the carry.

    Args:
      xy [..., G, 2], conic [..., G, 3], opacity [..., G], color [..., G, C],
      depth [..., G], depth_med [..., G] (the median's copy of the depth),
      valid [..., G] or [..., G, Q]; px, py [..., Q].
      base_index: segment-local index of this chunk's first instance
        (``n_contrib`` counts from it, 1-based).
      global_base: [...] or scalar, position of this chunk's first instance
        in the whole instance stream (``midx`` counts from it); defaults to
        ``base_index``.
    """
    alpha, v, p_incl, t_excl, contrib, w, cross = chunk_weights(
        carry.prod, xy, conic, opacity, valid, px, py, cfg)
    g = xy.shape[-2]
    dev = xy.device
    gi = torch.arange(g, dtype=torch.int32, device=dev)
    if global_base is None:
        global_base = base_index
    gb = torch.as_tensor(global_base, dtype=torch.int32, device=dev)
    idx = (base_index + 1 + gi)[:, None]                   # [G, 1]
    gidx = (gb[..., None] + gi)[..., None]                 # [..., G, 1]
    crossf = cross.to(w.dtype)
    cww = crossf * w

    # the variance and uncertainty moments read the pose-stopped copy: same
    # values, and under autograd (the oracle) the reference's routing, in
    # which the direct 2 w (d - gt) term reaches the means but not the pose
    d2 = depth_med * depth_med
    wsum = lambda f: torch.einsum("...g,...gq->...q", f, w)
    usum = lambda f: torch.einsum("...g,...gq->...q", f, cww)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    neg_i = torch.full((), -1, dtype=torch.int32, device=dev)

    return BlendCarry(
        prod=p_incl[..., -1, :],
        t_final=torch.minimum(carry.t_final, torch.where(
            contrib, p_incl, torch.ones_like(p_incl)).amin(dim=-2)),
        color=carry.color + torch.einsum("...gc,...gq->...cq", color, w),
        depth=carry.depth + wsum(depth),
        weight=carry.weight + w.sum(dim=-2),
        median=carry.median + torch.einsum("...g,...gq->...q", depth_med,
                                           crossf),
        var_dd=carry.var_dd + wsum(d2),
        var_d=carry.var_d + wsum(depth_med),
        n_contrib=torch.maximum(carry.n_contrib, torch.where(
            contrib, idx, zero_i).amax(dim=-2)),
        n_valid=carry.n_valid + contrib.sum(dim=-2, dtype=torch.int32),
        midx=torch.maximum(carry.midx, torch.where(
            cross, gidx, neg_i).amax(dim=-2)),
        ucross_dd=carry.ucross_dd + usum(d2),
        ucross_d=carry.ucross_d + usum(depth_med),
        ucross_w=carry.ucross_w + cww.sum(dim=-2),
    )


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

# Rows of the per-pixel backward constants built by bwd_pixel_inputs.
PIX_ROWS = 10


class BlendBwdCarry(NamedTuple):
    """Running per-pixel state of the backward pass (all [..., Q])."""

    prod: torch.Tensor     # the forward's running product
    pre_all: torch.Tensor  # inclusive prefix of w * s


def init_bwd_carry(shape, dtype=torch.float32, device="cuda") -> BlendBwdCarry:
    shape = tuple(shape)
    return BlendBwdCarry(
        prod=torch.ones(shape, dtype=dtype, device=device),
        pre_all=torch.zeros(shape, dtype=dtype, device=device))


def bwd_pixel_inputs(gt, tot_c, tot_d, tot_w, tot_v, t_final, dL_dc, dL_dd,
                     dL_dw, dL_dvar, dL_dmed, dL_dtf):
    """The per-pixel constants of the backward, ``[..., 10, Q]``.

    Rows 0-5 are ``pixcot``, the cotangents that instance features
    ``[r, g, b, d, d^2, 1]`` are dotted with (``(d - gt)^2`` of the
    variance expands into them, gt being a pixel constant): dL_dc (3),
    dL_dd - 2 gt dL_dvar, dL_dvar, dL_dw + gt^2 dL_dvar.  Then dL_dd, gt,
    ``tot_all`` (the same dot product with the pixel's forward totals, plus
    ``t_final * dL_dtf``: the background's gradient reaches the core as the
    cotangent of ``t_final``) and dL_dmed.  ``tot_c``/``dL_dc`` are
    [..., 3, Q], the rest [..., Q].
    """
    tot_all = ((dL_dc * tot_c).sum(dim=-2) + dL_dd * tot_d + dL_dvar * tot_v
               + dL_dw * tot_w + t_final * dL_dtf)
    rows = [dL_dd - 2.0 * gt * dL_dvar, dL_dvar, dL_dw + gt * gt * dL_dvar,
            dL_dd, gt, tot_all, dL_dmed]
    return torch.cat([dL_dc, torch.stack(rows, dim=-2)], dim=-2)


def blend_chunk_bwd(carry: BlendBwdCarry, xy, conic, opacity, color, depth,
                    valid, px, py, pix, cfg: RasterConfig,
                    want_med: bool = True, want_var: bool = True):
    """One forward-ordered backward chunk.

    Args: the instance fields as for :func:`blend_chunk_fwd` (``depth`` is
    the depth column; its median/variance copy has the same values),
    ``valid`` [..., G, Q], ``pix`` [..., 10, Q] from
    :func:`bwd_pixel_inputs`.  ``want_med``/``want_var`` False leave the
    median and variance columns zero (their cotangents are absent).

    Returns (new carry, rows [..., G, 12]) with the columns of
    ``kernels/render.py``'s ``ROW_COLUMNS``: d_xy (pixel units), the true
    gradient of the packed conic (A, B, C), d_opacity, d_color, d_depth
    (the depth output's term), d_depth_var (the 2 w (d - gt) term) and
    d_depth_med (the median crossing).  The per-instance sums over pixels
    are taken directly, with ``dx = x - px``, as the CUDA kernel takes them.
    """
    power = splat_power(xy, conic, px, py)
    g = torch.exp(power)
    alpha = torch.clamp_max(opacity[..., None] * g, cfg.alpha_cap)
    v = valid & (power <= 0.0) & (alpha >= cfg.alpha_min)
    oma = 1.0 - alpha
    a_eff = torch.where(v, oma, torch.ones_like(alpha))
    p_incl = carry.prod[..., None, :] * torch.cumprod(a_eff, dim=-2)
    t_excl = torch.cat([carry.prod[..., None, :], p_incl[..., :-1, :]],
                       dim=-2)
    contrib = v & (p_incl >= cfg.t_terminate)
    contribf = contrib.to(g.dtype)
    w = contribf * alpha * t_excl

    pixcot = pix[..., 0:6, :]
    dL_dd, gt, tot_all, dL_dmed = (pix[..., k, :] for k in range(6, 10))
    feats = torch.cat([color, depth[..., None], (depth * depth)[..., None],
                       torch.ones_like(depth)[..., None]], dim=-1)
    s = torch.einsum("...gf,...fq->...gq", feats, pixcot)
    pre_all = carry.pre_all[..., None, :] + torch.cumsum(w * s, dim=-2)
    # dL/dalpha_i * T_i: the strict suffix tot_all - prefix, over (1 - a_i);
    # alpha <= alpha_cap < 1 needs no guard.  Like the reference, the cap
    # is ignored: dalpha/dpower = op * G even where alpha = alpha_cap.
    d_alpha = contribf * (t_excl * s - (tot_all[..., None, :] - pre_all)
                          * (1.0 / oma))
    e = d_alpha * g
    dx = xy[..., 0:1] - px[..., None, :]
    dy = xy[..., 1:2] - py[..., None, :]
    s_e = e.sum(dim=-1)
    s_dx, s_dy = (e * dx).sum(dim=-1), (e * dy).sum(dim=-1)
    s_dxx, s_dyy = (e * dx * dx).sum(dim=-1), (e * dy * dy).sum(dim=-1)
    s_dxy = (e * dx * dy).sum(dim=-1)

    op = opacity
    A, B, C = conic[..., 0], conic[..., 1], conic[..., 2]
    wsum = lambda f: (w * f[..., None, :]).sum(dim=-1)
    zero = torch.zeros_like(s_e)
    if want_var:
        d_var = 2.0 * (w * (depth[..., None] - gt[..., None, :])
                       * pixcot[..., 4:5, :]).sum(dim=-1)
    else:
        d_var = zero
    if want_med:
        cross = contrib & (t_excl > 0.5) & (p_incl < 0.5)
        d_med = (cross.to(g.dtype) * dL_dmed[..., None, :]).sum(dim=-1)
    else:
        d_med = zero
    rows = torch.stack([
        -op * (A * s_dx + B * s_dy), -op * (C * s_dy + B * s_dx),
        -0.5 * op * s_dxx, -op * s_dxy, -0.5 * op * s_dyy, s_e,
        wsum(pixcot[..., 0, :]), wsum(pixcot[..., 1, :]),
        wsum(pixcot[..., 2, :]), wsum(dL_dd), d_var, d_med], dim=-1)
    return BlendBwdCarry(prod=p_incl[..., -1, :],
                         pre_all=pre_all[..., -1, :]), rows
