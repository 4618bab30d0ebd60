"""Gaussian map model (PyTorch port of the JAX package's
``models/gaussians.py``): parameters, activations, the densification
statistics, and densify and prune.

A static-capacity set: the model owns ``capacity`` slots and an ``active``
mask; inactive slots render with zero opacity.  The densification signal
is the screen-space position gradient, read from a zero ``means2D`` input
(``DensifyState``).  ``densify_and_prune`` and ``prune_by_uncertainty``
write into the model's own parameter tensors in place (under
``torch.no_grad()``), so an optimizer that holds them keeps its state, as
the JAX package keeps its optax state across slot writes: the moments of
a reused slot are not reset.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..ops.sh import num_sh_coeffs, rgb_to_sh0

PARAM_FIELDS = ("means3D", "scales_log", "rotations", "opacities_logit",
                "sh")


class GaussianModel(nn.Module):
    """Parameters ``means3D`` (N,3), ``scales_log`` (N,3, exp-activated),
    ``rotations`` (N,4 raw quaternions), ``opacities_logit`` (N,1,
    sigmoid-activated), ``sh`` (N,M,3); buffer ``active`` (N,) bool."""

    def __init__(self, means3D, scales_log, rotations, opacities_logit, sh,
                 active):
        super().__init__()
        self.means3D = nn.Parameter(means3D)
        self.scales_log = nn.Parameter(scales_log)
        self.rotations = nn.Parameter(rotations)
        self.opacities_logit = nn.Parameter(opacities_logit)
        self.sh = nn.Parameter(sh)
        self.register_buffer("active", active)

    @property
    def capacity(self) -> int:
        return self.means3D.shape[0]

    @property
    def num_active(self):
        return self.active.sum()

    @property
    def scales(self):
        return torch.exp(self.scales_log)

    @property
    def opacities(self):
        # inactive slots render with zero opacity: culled from every tile
        op = torch.sigmoid(self.opacities_logit)
        return torch.where(self.active[:, None], op, torch.zeros_like(op))

    def raster_kwargs(self, sh_degree: int = None):
        """Keyword arguments for ``ops.rasterize.rasterize``."""
        m = self.sh.shape[1]
        deg = int(round(m ** 0.5)) - 1 if sh_degree is None else sh_degree
        return dict(opacities=self.opacities, scales=self.scales,
                    rotations=self.rotations, shs=self.sh, sh_degree=deg)


def init_model(capacity: int, sh_degree: int = 0, dtype=torch.float32,
               means=None, colors=None, scales=None, opacity: float = 0.1,
               active=None, device="cuda") -> GaussianModel:
    """Create a model, optionally seeding the first slots from a point
    cloud (``means`` (n,3), ``colors`` (n,3) RGB, ``scales`` (n,3))."""
    m = num_sh_coeffs(sh_degree)
    kw = dict(dtype=dtype, device=device)
    means3D = torch.zeros((capacity, 3), **kw)
    scales_log = torch.full((capacity, 3), -5.0, **kw)
    rotations = torch.tensor([1.0, 0.0, 0.0, 0.0], **kw).repeat(capacity, 1)
    opacities_logit = torch.full((capacity, 1), _logit(opacity), **kw)
    sh = torch.zeros((capacity, m, 3), **kw)
    act = torch.zeros((capacity,), dtype=torch.bool, device=device)
    if means is not None:
        n = means.shape[0]
        means3D[:n] = torch.as_tensor(means, **kw)
        act[:n] = True if active is None else torch.as_tensor(
            active, dtype=torch.bool, device=device)
        if colors is not None:
            sh[:n, 0] = rgb_to_sh0(torch.as_tensor(colors, **kw))
        if scales is not None:
            scales_log[:n] = torch.log(torch.as_tensor(scales, **kw))
    return GaussianModel(means3D, scales_log, rotations, opacities_logit, sh,
                         act)


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


@dataclasses.dataclass(frozen=True)
class DensifyState:
    """Screen-gradient statistics accumulated between densify steps."""

    grad_accum: torch.Tensor  # (N,) sum of ||dL/d(ndc xy)|| over visible views
    denom: torch.Tensor       # (N,) views in which the Gaussian was visible

    @classmethod
    def zero(cls, capacity: int, dtype=torch.float32, device="cuda"):
        z = lambda: torch.zeros(capacity, dtype=dtype, device=device)
        return cls(grad_accum=z(), denom=z())

    def update(self, means2D_grad, visible) -> "DensifyState":
        g = torch.linalg.norm(means2D_grad, dim=-1)
        vis = visible.to(g.dtype)
        return DensifyState(grad_accum=self.grad_accum + g * vis,
                            denom=self.denom + vis)


def split_noise(generator, max_new: int, dtype=torch.float32,
                device="cuda"):
    """The standard-normal draws of ``densify_and_prune``'s split samples,
    ``(max_new, 3)``, from ``generator`` (a CPU ``torch.Generator``; seed
    0 when None), so the draws do not depend on the device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randn((max_new, 3), generator=generator,
                       dtype=dtype).to(device)


def densify_and_prune(model: GaussianModel, state: DensifyState, *,
                      grad_threshold: float = 2e-4,
                      percent_dense: float = 0.01, scene_extent: float = 1.0,
                      opacity_cull: float = 0.005, max_new: int = 0,
                      split_scale_down: float = 1.6, generator=None,
                      noise=None):
    """3DGS clone/split/prune with static shapes, in place.

    Candidates (active, mean screen gradient above ``grad_threshold``) are
    ranked by that gradient; up to ``max_new`` (default ``capacity // 8``)
    are copied into the first inactive slots, in slot order.  A candidate
    larger than ``percent_dense * scene_extent`` is split: its copy is
    moved by ``noise * scale`` (``noise`` from :func:`split_noise` unless
    given) and both shrink by ``split_scale_down``; a smaller one is
    cloned.  Last, Gaussians with opacity at most ``opacity_cull`` are
    deactivated.  Returns (a zero ``DensifyState``, the number spawned as
    a tensor).
    """
    cap = model.capacity
    if max_new <= 0:
        max_new = cap // 8
    dt, dev = model.means3D.dtype, model.means3D.device
    if noise is None:
        noise = split_noise(generator, max_new, dt, dev)
    shrink_log = math.log(split_scale_down)
    with torch.no_grad():
        avg_grad = state.grad_accum / torch.clamp_min(state.denom, 1.0)
        is_large = model.scales.amax(-1) > percent_dense * scene_extent
        candidate = model.active & (avg_grad > grad_threshold)
        # rank by gradient score (stable: ties keep slot order, like
        # jnp.argsort); inactive slots first as destinations
        score = torch.where(candidate, avg_grad,
                            torch.full_like(avg_grad, -math.inf))
        src = torch.argsort(-score, stable=True)[:max_new]
        dst = torch.argsort(model.active.to(torch.int8),
                            stable=True)[:max_new]
        dst_ok = ~model.active[dst] & candidate[src]
        split = is_large[src]
        src_log = model.scales_log[src]
        new_rows = dict(
            means3D=torch.where(split[:, None],
                                model.means3D[src] + noise * model.scales[src],
                                model.means3D[src]),
            scales_log=torch.where(split[:, None], src_log - shrink_log,
                                   src_log),
            rotations=model.rotations[src],
            opacities_logit=model.opacities_logit[src],
            sh=model.sh[src])
        for name, rows in new_rows.items():
            param = getattr(model, name)
            ok = dst_ok.reshape((-1,) + (1,) * (rows.dim() - 1))
            param[dst] = torch.where(ok, rows, param[dst])
        model.active[dst] = model.active[dst] | dst_ok
        # the split source also shrinks in place
        src_log = model.scales_log[src]
        model.scales_log[src] = torch.where(
            (dst_ok & split)[:, None], src_log - shrink_log, src_log)
        # prune: transparent Gaussians die
        op = torch.sigmoid(model.opacities_logit[:, 0])
        model.active.copy_(model.active & (op > opacity_cull))
    return (DensifyState.zero(cap, dtype=dt, device=dev),
            dst_ok.sum())


def prune_by_uncertainty(model: GaussianModel, gau_uncertainty,
                         gau_related_pixels, threshold: float):
    """CG-SLAM-style uncertainty-aware pruning, in place: deactivate the
    Gaussians whose mean depth uncertainty per related pixel exceeds
    ``threshold``."""
    with torch.no_grad():
        n = gau_related_pixels[:, 0]
        u = gau_uncertainty[:, 0] / torch.clamp_min(
            n.to(gau_uncertainty.dtype), 1.0)
        model.active.copy_(model.active & ~((n > 0) & (u > threshold)))
