"""Front-to-back alpha blending as masked prefix products (forward half).

PyTorch port of the forward functions of the JAX package's ``ops/blend.py``.
Per pixel, instances sorted front to back:

- ``a_i = 1 - alpha_i`` where the instance passes the validity tests
  (``power <= 0`` and ``alpha >= alpha_min``), else 1;
- the inclusive prefix product ``P_i = prod_{j<=i} a_j`` is the
  transmittance after instance i.  Since ``P`` never increases, stopping
  *before* accumulating once ``P_i < t_terminate`` is the mask
  ``contrib_i = valid_i & (P_i >= t_terminate)``;
- blend weights are ``w_i = alpha_i * P_{i-1} * contrib_i``, and the median
  crossing is ``contrib & (P_{i-1} > 0.5) & (P_i < 0.5)``, which fires at
  most once per pixel.

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

    d2 = depth * depth
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
        var_d=carry.var_d + wsum(depth),
        n_contrib=torch.maximum(carry.n_contrib, torch.where(
            contrib, idx, zero_i).amax(dim=-2)),
        n_valid=carry.n_valid + contrib.sum(dim=-2, dtype=torch.int32),
        midx=torch.maximum(carry.midx, torch.where(
            cross, gidx, neg_i).amax(dim=-2)),
        ucross_dd=carry.ucross_dd + usum(d2),
        ucross_d=carry.ucross_d + usum(depth),
        ucross_w=carry.ucross_w + cww.sum(dim=-2),
    )
