"""The work counts against hand counts on a scene of one splat, and the
roofline arithmetic."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from splatbench import reference as ref
from splatbench import work


def one_splat(z=2.0, s=0.05, op=0.8, size=32):
    """One isotropic splat straight ahead of an identity camera with
    tan(fov/2) = 1 on a ``size`` x ``size`` image."""
    fields = dict(means3D=torch.tensor([[0.0, 0.0, z]]),
                  scales_log=torch.full((1, 3), math.log(s)),
                  rotations=torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
                  opacities_logit=torch.tensor([[math.log(op / (1 - op))]]),
                  sh=torch.zeros((1, 1, 3)),
                  active=torch.ones(1, dtype=torch.bool))
    return fields, ref.Cam(size, size, 1.0, 1.0)


def test_counts_match_a_hand_count():
    z, s, op, size = 2.0, 0.05, 0.8, 32
    fields, cam = one_splat(z, s, op, size)
    R = ref.Raster(tile_h=16, tile_w=16)
    view = torch.eye(4)
    (inst, contrib), = work.pool_counts(fields, view[None], cam, R)
    # by hand: sigma^2 = (f s / z)^2 + low-pass, centre at ((W-1)/2,
    # (H-1)/2), and a pixel contributes where op exp(-d^2 / 2 sigma^2)
    # reaches the alpha floor
    f = size / 2.0
    var = (f * s / z) ** 2 + R.lowpass
    r2 = 2 * var * math.log(op / R.alpha_min)
    c = (size - 1) / 2
    yy, xx = np.mgrid[0:size, 0:size]
    assert contrib == int(((xx - c) ** 2 + (yy - c) ** 2 <= r2).sum())
    # the alpha-floor disc (radius ~5.9 px) around the image centre
    # reaches all four 16 x 16 tiles
    assert inst == 4


def test_pieces_by_hand():
    p = work.blend_fwd(inst=10, contrib=100, px=64, tiles=4)
    assert p.ops == 100 * (work.TEST + work.ACC) + 64 * work.PIX
    assert p.nbytes == 4 * (10 * 11 + 4 * 2 + 64 + 64 * 9 + 10 * 2)
    b = work.blend_bwd(inst=10, contrib=100, px=64, tiles=4, gauss=3)
    assert b.ops == 100 * (work.TEST + work.BWD) + 64 * work.PIX
    a = work.adam(1000)
    assert a == work.Piece(12000.0, 28000.0)
    w = work.Work(dict(x=p, y=a))
    assert w.total() == p + a and w.get("z") == work.ZERO


def test_bound_is_the_larger_side():
    assert work.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(67e9, 3.35e12) == pytest.approx(1.0)
