"""Front-to-back alpha blending as masked prefix products, and its VJP.

PyTorch port of the JAX package's ``ops/blend.py``.  Per pixel, instances
sorted front to back:

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

The dual forward (:func:`blend_chunk_fwd_jvp`) carries K pose tangents
through the same chunk: the forward's weights with the selection masks
frozen, and per tangent the exact derivative of every weight.

Every function takes any number of leading batch dimensions: instance
tensors are ``[..., G, k]``, pixel tensors ``[..., Q]``, masks and weights
``[..., G, Q]``.  The plain render core (``kernels/render.py``) runs them on
a batch of tiles at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RasterConfig


def moment_basis(px, py, origin=None):
    """The pixel basis ``[1, x, y, x^2, y^2, x y]`` [..., 6, Q] of pixel
    coordinates ``px, py`` [..., Q] taken about ``origin`` (a pair of
    scalars or of [...] tensors; default: each batch's first pixel)."""
    at = lambda o: torch.as_tensor(o, dtype=px.dtype, device=px.device)
    ox = px[..., 0] if origin is None else at(origin[0])
    oy = py[..., 0] if origin is None else at(origin[1])
    pxl = px - ox[..., None]
    pyl = py - oy[..., None]
    return torch.stack([torch.ones_like(pxl), pxl, pyl, pxl * pxl,
                        pyl * pyl, pxl * pyl], dim=-2)


def splat_basis_coeffs(xy, conic, origin):
    """The basis form's six coefficients ``(c0, .., c5)``, each
    [..., G, 1], of splats ``xy`` [..., G, 2], ``conic`` [..., G, 3] about
    ``origin`` (a pair of scalars or of [...] tensors): the JAX package's
    expressions, in its operand order."""
    A, B, C = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    ox, oy = (torch.as_tensor(o, dtype=xy.dtype, device=xy.device)
              for o in origin)
    xg = xy[..., 0:1] - ox[..., None, None]
    yg = xy[..., 1:2] - oy[..., None, None]
    return (-0.5 * A * xg * xg - 0.5 * C * yg * yg - B * xg * yg,
            A * xg + B * yg, C * yg + B * xg, -0.5 * A, -0.5 * C, -B)


def splat_power(xy, conic, px, py, basis=None, origin=None):
    """Per (instance, pixel) Gaussian exponent, shape [..., G, Q].

    Direct form: ``-0.5 (A dx^2 + C dy^2) - B dx dy``.  With ``basis``
    (:func:`moment_basis` about ``origin``, [..., 6, Q]), the basis form of
    the JAX package's ``splat_power``: the same quadratic expanded about
    the origin, six coefficients a splat against the pixel basis, summed
    left to right in elementwise float32 operations (a matmul would leave
    the order to a BLAS).  The CUDA kernels' ``splat_power_basis`` takes
    the same operations in the same order, so the two are bit-equal; the
    expansion's rounding grows with ``|c0| ~ 0.5 A xg^2``, about 1e-4 in
    power for a centre a tile from the origin."""
    if basis is None:
        A, B, C = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
        dx = xy[..., 0:1] - px[..., None, :]
        dy = xy[..., 1:2] - py[..., None, :]
        return -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    c0, c1, c2, c3, c4, c5 = splat_basis_coeffs(xy, conic, origin)
    b = basis[..., None, :, :]                              # [..., 1, 6, Q]
    return (c0 + c1 * b[..., 1, :] + c2 * b[..., 2, :] + c3 * b[..., 3, :]
            + c4 * b[..., 4, :] + c5 * b[..., 5, :])


def splat_alpha(xy, conic, opacity, px, py, cfg: RasterConfig, basis=None,
                origin=None):
    """alpha [..., G, Q] and ok [..., G, Q] (power <= 0 and
    alpha >= alpha_min); ``basis``/``origin`` as in :func:`splat_power`."""
    power = splat_power(xy, conic, px, py, basis, origin)
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
                  cfg: RasterConfig, basis=None, origin=None):
    """Alphas, transmittances, blend weights and the median-crossing mask of
    one [..., G, Q] chunk.  ``valid`` is [..., G, Q] or [..., G];
    ``basis``/``origin`` as in :func:`splat_power`.

    Returns (alpha, v, p_incl, t_excl, contrib, w, cross)."""
    alpha, ok = splat_alpha(xy, conic, opacity, px, py, cfg, basis, origin)
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
                    global_base=None, weights=None, basis=None,
                    origin=None) -> BlendCarry:
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
      weights: this chunk's :func:`chunk_weights`, when the caller has
        them already.
      basis, origin: the splat exponent's basis form (:func:`splat_power`).
    """
    if weights is None:
        weights = chunk_weights(carry.prod, xy, conic, opacity, valid, px,
                                py, cfg, basis, origin)
    alpha, v, p_incl, t_excl, contrib, w, cross = weights
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
# dual forward: the blend plus K pose tangents
# --------------------------------------------------------------------------


JVP_REFUSAL = "pose-jvp requires the direct splat path"


def check_direct_for_jvp(cfg: RasterConfig):
    """The dual render's refusal of ``cfg.splat_basis_power``: its
    tangents differentiate the direct exponent (the JAX package asserts
    the same, with this reason)."""
    if cfg.splat_basis_power:
        raise ValueError(f"{JVP_REFUSAL} (splat_basis_power=True)")


class JvpCarry(NamedTuple):
    """Running state of the dual pass (forward + K pose tangents).  The
    tangent streams are stacked on a K axis just before the pixel axis.

    Math (the selection masks frozen): with ``s_i = dalpha_i / (1 -
    alpha_i)`` summed over contributors into ``S``, ``dT_i = -T_i *
    S^excl_i``, so ``dw_i = w_i * (dpower_i - S^excl_i)`` on uncapped
    contributors (``dalpha = alpha * dpower`` there, 0 where alpha is
    capped), and every accumulated output tangent is one more contraction
    against ``dw``.
    """

    primal: BlendCarry
    s: torch.Tensor       # [..., K, Q] running sum of s over contributors
    color: torch.Tensor   # [..., K, C, Q]
    depth: torch.Tensor   # [..., K, Q]
    weight: torch.Tensor  # [..., K, Q]
    median: torch.Tensor  # [..., K, Q]


def init_jvp_carry(shape, k: int, channels: int = 3, dtype=torch.float32,
                   device="cuda") -> JvpCarry:
    """The initial dual carry for pixel tensors of ``shape`` ([..., Q])
    and ``k`` tangents."""
    shape = tuple(shape)
    lead, q = shape[:-1], shape[-1:]
    z = lambda *mid: torch.zeros(lead + (k,) + mid + q, dtype=dtype,
                                 device=device)
    return JvpCarry(primal=init_carry(shape, channels, dtype, device),
                    s=z(), color=z(channels), depth=z(), weight=z(),
                    median=z())


def blend_chunk_fwd_jvp(carry: JvpCarry, xy, conic, opacity, color, depth,
                        depth_med, tan_xy, tan_depth, valid, px, py,
                        base_index, cfg: RasterConfig, global_base=None,
                        tan_depth_med=None, tan_conic=None,
                        tan_color=None) -> JvpCarry:
    """One chunk of the forward blend plus exact propagation of K pose
    tangents.

    The instance and pixel arguments are :func:`blend_chunk_fwd`'s.
    Tangents enter through the splat centers and depths, ``tan_xy``
    [..., K, G, 2] and ``tan_depth`` [..., K, G] (the light variant's pose
    Jacobian); ``tan_conic`` [..., K, G, 3] (dA, dB, dC) also propagates
    the 2D-covariance branch, the full variant's, through
    ``dpower -= 0.5 dx^2 dA + dx dy dB + 0.5 dy^2 dC``; ``tan_color``
    [..., K, G, C] (the colours' own tangents, the SH colour branch) adds
    ``tan_color w`` to the colour's tangent.  The median's
    tangent sums ``tan_depth_med`` [..., K, G] over the (frozen) crossing;
    None leaves it unchanged, as in the render path, where the median reads
    the pose-detached depth copy.

    The tangents differentiate the direct form of the exponent: the dual
    render's entry points refuse ``cfg.splat_basis_power``
    (:func:`check_direct_for_jvp`), and this chunk takes no basis.
    """
    weights = chunk_weights(carry.primal.prod, xy, conic, opacity, valid,
                            px, py, cfg)
    alpha, _, _, _, contrib, w, cross = weights
    primal = blend_chunk_fwd(carry.primal, xy, conic, opacity, color, depth,
                             depth_med, valid, px, py, base_index, cfg,
                             global_base=global_base, weights=weights)

    # shared by all tangents: the quadratic form's partials and the rate
    dxp = xy[..., 0:1] - px[..., None, :]                   # [..., G, Q]
    dyp = xy[..., 1:2] - py[..., None, :]
    a_, b_, c_ = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    gx = (a_ * dxp + b_ * dyp)[..., None, :, :]             # -dpower/dx
    gy = (c_ * dyp + b_ * dxp)[..., None, :, :]             # -dpower/dy
    capped = alpha >= cfg.alpha_cap
    zero = torch.zeros_like(alpha)
    rate = torch.where(contrib & ~capped, alpha / (1.0 - alpha), zero)

    dpow = -(gx * tan_xy[..., 0:1] + gy * tan_xy[..., 1:2])  # [..., K, G, Q]
    if tan_conic is not None:
        dxe, dye = dxp[..., None, :, :], dyp[..., None, :, :]
        dpow = (dpow - (0.5 * tan_conic[..., 0:1] * dxe
                        + tan_conic[..., 1:2] * dye) * dxe
                - 0.5 * tan_conic[..., 2:3] * dye * dye)
    s = rate[..., None, :, :] * dpow
    s_tot = carry.s[..., None, :] + torch.cumsum(s, dim=-2)  # inclusive S
    s_excl = s_tot - s
    wk = w[..., None, :, :]
    dw = wk * (torch.where(capped[..., None, :, :], zero[..., None, :, :],
                           dpow) - s_excl)
    if tan_depth_med is None:
        median = carry.median
    else:
        median = carry.median + torch.einsum(
            "...kg,...gq->...kq", tan_depth_med, cross.to(w.dtype))
    dcolor = carry.color + torch.einsum("...gc,...kgq->...kcq", color, dw)
    if tan_color is not None:
        dcolor = dcolor + torch.einsum("...kgc,...gq->...kcq", tan_color, w)
    return JvpCarry(
        primal=primal,
        s=s_tot[..., -1, :],
        color=dcolor,
        depth=(carry.depth + torch.einsum("...g,...kgq->...kq", depth, dw)
               + torch.einsum("...kg,...gq->...kq", tan_depth, w)),
        weight=carry.weight + dw.sum(dim=-2),
        median=median,
    )


def finish_t_final_tangent(carry: JvpCarry):
    """[..., K, Q] tangents of t_final, ``dT_final = -T_final * S_final``
    (s is zero past termination, so S ends at the last contributor,
    where t_final froze)."""
    return -carry.primal.t_final[..., None, :] * carry.s


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
                    want_med: bool = True, want_var: bool = True,
                    basis=None, origin=None):
    """One forward-ordered backward chunk.

    Args: the instance fields as for :func:`blend_chunk_fwd` (``depth`` is
    the depth column; its median/variance copy has the same values),
    ``valid`` [..., G, Q], ``pix`` [..., 10, Q] from
    :func:`bwd_pixel_inputs`.  ``want_med``/``want_var`` False leave the
    median and variance columns zero (their cotangents are absent).
    ``basis``/``origin`` take the exponent in its basis form
    (:func:`splat_power`), as the forward did: the walk's decisions must be
    the forward's, and ``G = exp(power)`` feeds the gradient terms too.

    Returns (new carry, rows [..., G, 12]) with the columns of
    ``kernels/render.py``'s ``ROW_COLUMNS``: d_xy (pixel units), the true
    gradient of the packed conic (A, B, C), d_opacity, d_color, d_depth
    (the depth output's term), d_depth_var (the 2 w (d - gt) term) and
    d_depth_med (the median crossing).  The per-instance sums over pixels
    are taken directly, with ``dx = x - px``, as the CUDA kernel takes them.
    """
    power = splat_power(xy, conic, px, py, basis, origin)
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
