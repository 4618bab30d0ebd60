"""Gaussian map model (PyTorch port of the JAX package's
``models/gaussians.py``): parameters, activations, and the densification
statistics.

A static-capacity set: the model owns ``capacity`` slots and an ``active``
mask; inactive slots render with zero opacity.  The densification signal
is the screen-space position gradient, read from a zero ``means2D`` input
(``DensifyState``).  Densify and prune themselves are not ported yet.
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
    opacities_logit = torch.full((capacity, 1),
                                 math.log(opacity / (1.0 - opacity)), **kw)
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
