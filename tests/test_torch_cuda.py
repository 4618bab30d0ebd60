"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor ``tests/scenes.py``, so it also runs where JAX is
not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are those of the kernel comparisons in
``test_pallas_kernels.py``: forward float fields rtol 1e-4 / atol 2e-5 on
the pixels whose integer fields agree, integer fields a mismatch fraction
below 5e-3 (the kernel's sequential ``T *= 1 - alpha`` rounds differently
from the plain version's chunked cumprod, so pixels exactly on the
t_terminate or 0.5 thresholds may flip); backward rows rtol 1e-3 /
atol 2e-4 on the tiles whose ``n_contrib`` agrees on every pixel; card
gradients against the CPU path's at ``test_rasterize.py``'s gradient
tolerance, rtol 5e-4 / atol 2e-5.
"""

import pytest
import torch

from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
from diff_gaussian_rasterization_tpu_torch.ops.kernels.segment_sum import (
    segment_sum_rows, segment_sum_rows_reference)
from diff_gaussian_rasterization_tpu_torch.scenes import (
    bench_camera, bench_scene, small_scene)

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


def bwd_inputs(tile, device, seed=0):
    """The forward on ``device`` (the kernel on the card) and random
    cotangents from a seeded generator."""
    args, ckw = core_inputs(tile, device=device)
    fwd = render.core_fwd(*args, **ckw)
    t, q = fwd.depth.shape
    g = torch.Generator().manual_seed(seed)
    cots = tuple(torch.randn(s, generator=g).to(device) for s in
                 [(t, 3, q), (t, q), (t, q), (t, q), (t, q), (t, q)])
    totals = (fwd.color, fwd.depth, fwd.weight, fwd.var, fwd.t_final)
    return args, ckw, fwd, totals, cots


@pytest.mark.parametrize("tile", [(8, 16), (16, 16), (32, 32)])
@pytest.mark.parametrize("want", [(True, True), (False, False)])
def test_render_bwd_matches_plain(dev, tile, want):
    args, ckw, fwd, totals, cots = bwd_inputs(tile, dev)
    table, start, stop, gt = args
    kw = dict(ckw, want_med=want[0], want_var=want[1])
    before = render.launches["render_bwd"]
    k = render.core_bwd(table, start, stop, gt, totals, cots, **kw)
    torch.cuda.synchronize()
    assert render.launches["render_bwd"] == before + 1
    pix = render.blend.bwd_pixel_inputs(gt, *totals, *cots).contiguous()
    p = render.core_bwd_reference(table, start, stop, pix, **kw)
    plain_fwd = render.core_fwd_reference(*args, **ckw)
    tile_ok = (fwd.n_contrib == plain_fwd.n_contrib).all(dim=1)
    seg = (stop - start).to(torch.int64)
    inst_ok = torch.repeat_interleave(tile_ok, seg)
    first = int(start[0])
    rows_k = k[first:first + inst_ok.shape[0]][inst_ok]
    rows_p = p[first:first + inst_ok.shape[0]][inst_ok]
    torch.testing.assert_close(rows_k, rows_p, rtol=1e-3, atol=2e-4)
    assert float((~tile_ok).float().mean()) < 0.05
    if not want[0]:
        assert float(k[:, 11].abs().max()) == 0.0
    again = render.core_bwd(table, start, stop, gt, totals, cots, **kw)
    assert torch.equal(k, again)


def test_segment_sum_rows_matches_plain(dev):
    """The kernel adds each run in order: bit-equal to index_add_ on the
    CPU, which adds in the same order."""
    g = torch.Generator().manual_seed(0)
    p, cap = 5000, 20000
    lengths = torch.randint(0, 8, (p,), generator=g)
    ends = torch.cumsum(lengths, 0).clamp_max(cap)
    start = (ends - lengths).clamp(0, cap).to(torch.int32)
    stop = ends.to(torch.int32)
    rows = torch.randn(cap, 12, generator=g)
    inv = torch.randperm(cap, generator=g).to(torch.int32)
    before = render.launches["segment_sum_rows"]
    a = segment_sum_rows(*(x.to(dev) for x in (rows, inv, start, stop)))
    torch.cuda.synchronize()
    assert render.launches["segment_sum_rows"] == before + 1
    b = segment_sum_rows_reference(rows, inv, start, stop)
    assert torch.equal(a.cpu(), b)


def scene_grads(device, seed=13):
    """Gradients of every output through rasterize on ``device`` (the
    scene made on the CPU and moved)."""
    means, kw, cam = small_scene(p=200, h=40, w=56, seed=seed, sh_degree=1,
                                 device="cpu")
    cfg = RasterConfig(tile_h=8, tile_w=8, chunk=16, ref_depth_var=False)
    leaves = {"means3D": means, **{k: kw[k] for k in
              ("scales", "rotations", "opacities", "shs")}}
    leaves = {k: v.to(device).requires_grad_(True) for k, v in leaves.items()}
    view = cam.viewmatrix.to(device).requires_grad_(True)
    rest = {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in kw.items() if k not in leaves}
    out = ras.rasterize(leaves["means3D"], cam.replace(viewmatrix=view), cfg,
                        **{k: v for k, v in leaves.items() if k != "means3D"},
                        **rest)
    loss = (out.color.sum() + 0.3 * out.depth.sum()
            + 0.2 * out.opacity_map.sum() + 0.15 * out.depth_median.sum()
            + 0.1 * out.depth_var.sum())
    loss.backward()
    return {**{k: v.grad for k, v in leaves.items()}, "view": view.grad}


def test_rasterize_grads_card_match_cpu(dev):
    a = scene_grads("cpu")
    b = scene_grads(dev)
    for k in a:
        torch.testing.assert_close(b[k].cpu(), a[k], rtol=5e-4, atol=2e-5,
                                   msg=k)
        assert bool(torch.isfinite(b[k]).all())


def test_backward_bit_reproducible(dev):
    before = dict(render.launches)
    a = scene_grads(dev)
    b = scene_grads(dev)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert render.launches["render_bwd"] == before["render_bwd"] + 2
    assert render.launches["segment_sum_rows"] == \
        before["segment_sum_rows"] + 2


def jvp_inputs(tile, k_t, full, device, seed=0):
    """A small scene's sorted table and binning, and a seeded tangent
    table [I, per_k * K] (the same rows for the card and the CPU)."""
    args, ckw = core_inputs(tile, device=device)
    per_k = 6 if full else 3
    g = torch.Generator().manual_seed(seed)
    tans = torch.randn(args[0].shape[0], per_k * k_t, generator=g)
    return args, tans.to(device), dict(ckw, full=full)


def assert_tangents_close(k, p, fwd_k, fwd_p, rtol=2e-4):
    """Tangent streams on the tiles whose n_contrib agrees on every pixel,
    at rtol 2e-4 and atol 2e-5 + 2e-6 x the stream's largest value."""
    tile_ok = (fwd_k.n_contrib == fwd_p.n_contrib).all(dim=1)
    assert float((~tile_ok).float().mean()) < 0.05
    for name in ("color", "depth", "weight", "t_final"):
        x, y = getattr(k, name)[tile_ok], getattr(p, name)[tile_ok]
        atol = 2e-5 + 2e-6 * float(y.abs().max())
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol, msg=name)
    assert float(k.median.abs().max()) == 0.0


@pytest.mark.parametrize("k_t,full", [(6, False), (6, True), (1, False),
                                      (1, True)])
@pytest.mark.parametrize("tile", [(8, 16), (32, 32)])
def test_render_jvp_matches_plain(dev, tile, k_t, full):
    args, tans, ckw = jvp_inputs(tile, k_t, full, dev)
    before = render.launches["render_jvp"]
    out, tan = render.core_fwd_jvp(args[0], tans, *args[1:], **ckw)
    torch.cuda.synchronize()
    assert render.launches["render_jvp"] == before + 1
    p_out, p_tan = render.core_fwd_jvp_reference(args[0], tans, *args[1:],
                                                 **ckw)
    assert_core_close(out, p_out)
    assert_tangents_close(tan, p_tan, out, p_out)
    assert float(tan.color.abs().max()) > 0
    # the primal is render_fwd's, bit for bit
    fwd = render.core_fwd(*args, **{k: v for k, v in ckw.items()
                                    if k != "full"})
    for f in out._fields:
        assert torch.equal(getattr(out, f), getattr(fwd, f)), f
    again = render.core_fwd_jvp(args[0], tans, *args[1:], **ckw)
    for x, y in zip(tan, again[1]):
        assert torch.equal(x, y)


def test_render_jvp_rejects_other_k(dev):
    args, tans, ckw = jvp_inputs((8, 8), 2, False, dev)
    with pytest.raises(ValueError, match="instantiated"):
        render.core_fwd_jvp(args[0], tans, *args[1:], **ckw)
    with pytest.raises(ValueError):
        render.core_fwd_jvp(args[0], tans[:, :5].contiguous(), *args[1:],
                            **ckw)
