"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor ``tests/scenes.py``, so it also runs where JAX is
not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are those of the kernel comparisons in
``test_pallas_kernels.py``: float fields rtol 1e-4 / atol 2e-5 on the
pixels whose integer fields agree, integer fields a mismatch fraction below
5e-3 (the kernel's sequential ``T *= 1 - alpha`` rounds differently from
the plain version's chunked cumprod, so pixels exactly on the t_terminate
or 0.5 thresholds may flip).
"""

import pytest
import torch

from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
from diff_gaussian_rasterization_tpu_torch.scenes import (
    bench_camera, bench_scene)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def core_inputs(tile, p=3000, h=96, w=160, seed=1, device="cpu"):
    cfg = RasterConfig(tile_h=tile[0], tile_w=tile[1])
    means, kw = bench_scene(seed=seed, p=p, height=h, width=w, device=device)
    cam = bench_camera(height=h, width=w, device=device)
    prep_kw = {k: v for k, v in kw.items() if k not in ("bg", "gt_depth")}
    _, binn, feat, gt_tiles = ras.prepare(means, cam, cfg, 8 * p,
                                          kw["gt_depth"], **prep_kw)
    table = feat[binn.gauss_id].contiguous()
    ckw = dict(cfg=cfg, tiles_x=-(-w // tile[1]), height=h, width=w)
    return (table, binn.tile_start, binn.tile_stop, gt_tiles), ckw


def assert_core_close(a, b):
    agree = ((a.n_contrib == b.n_contrib) & (a.n_valid == b.n_valid)
             & (a.midx == b.midx))
    for name in ("n_contrib", "n_valid", "midx"):
        frac = float((getattr(a, name) != getattr(b, name)).float().mean())
        assert frac < 5e-3, (name, frac)
    for name in ("color", "depth", "weight", "median", "var", "t_final"):
        x, y = getattr(a, name), getattr(b, name)
        m = agree[:, None, :].expand_as(x) if x.dim() == 3 else agree
        torch.testing.assert_close(x[m], y[m], rtol=1e-4, atol=2e-5,
                                   msg=name)
    same = a.npix_inst == b.npix_inst
    assert float((~same).float().mean()) < 5e-3
    torch.testing.assert_close(a.u_inst[same], b.u_inst[same], rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("tile", [(8, 16), (8, 8), (16, 16), (32, 32)])
def test_render_fwd_matches_plain(dev, tile):
    args, ckw = core_inputs(tile, device=dev)
    before = render.launches["render_fwd"]
    k = render.core_fwd(*args, **ckw)
    torch.cuda.synchronize()
    assert render.launches["render_fwd"] == before + 1
    p = render.core_fwd_reference(*args, **ckw)
    assert_core_close(k, p)
    assert int((k.midx >= 0).sum()) > 0
    again = render.core_fwd(*args, **ckw)
    for x, y in zip(k, again):
        assert torch.equal(x, y)


def test_render_fwd_rejects_bad_inputs(dev):
    args, ckw = core_inputs((8, 8), p=200, h=32, w=48, device=dev)
    table, start, stop, gt = args
    with pytest.raises(ValueError):
        render.core_fwd(table.double(), start, stop, gt, **ckw)
    with pytest.raises(ValueError):
        render.core_fwd(table, start.long(), stop, gt, **ckw)
    with pytest.raises(ValueError):
        big = ckw["cfg"].replace(tile_h=64, tile_w=32)
        render.core_fwd(table, start, stop, gt, **dict(ckw, cfg=big))


def test_segment_sum_matches_plain(dev):
    g = torch.Generator().manual_seed(0)
    keys = torch.randint(-1, 300, (20000,), generator=g)
    vals = torch.randn(20000, generator=g)
    ivals = torch.randint(0, 3, (20000,), generator=g, dtype=torch.int32)
    a = render.scatter_sum(keys.to(dev), vals.to(dev), ivals.to(dev), 300)
    b = render.scatter_sum(keys, vals, ivals, 300)
    # both sum each key's values in input order: bit-equal
    assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1])


def test_rasterize_card_matches_cpu(dev):
    means, kw = bench_scene(seed=2, p=3000, height=96, width=160,
                            device="cpu")
    cfg = RasterConfig(tile_h=16, tile_w=16)
    with torch.no_grad():
        a = ras.rasterize(means, bench_camera(height=96, width=160,
                                              device="cpu"), cfg, **kw)
        b = ras.rasterize(means.to(dev), bench_camera(
            height=96, width=160, device=dev), cfg,
            **{k: v.to(dev) for k, v in kw.items()})
        c = ras.rasterize(means.to(dev), bench_camera(
            height=96, width=160, device=dev), cfg,
            **{k: v.to(dev) for k, v in kw.items()})
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f).cpu()
        if x.dtype.is_floating_point:
            torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-4, msg=f)
        else:
            assert float((x != y).float().mean()) < 5e-3, f
        assert torch.equal(getattr(b, f), getattr(c, f)), f
