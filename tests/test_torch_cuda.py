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

import os

import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
from diff_gaussian_rasterization_tpu_torch.ops.kernels.segment_sum import (
    scatter_sum, segment_sum_rows, segment_sum_rows_reference)
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


@pytest.mark.parametrize("tile", [(8, 16), (8, 8), (16, 16), (32, 32),
                                  (12, 20)])
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


def test_render_fwd_culls_pairs(dev):
    """On 32x32 tiles of a scene whose pixels terminate and whose segments
    run past 1,024 instances, the counter build tests at least one pair per
    contribution and fewer pairs than the pixels' segments hold up to their
    termination, and counting changes no output bit."""
    args, ckw = core_inputs((32, 32), p=12000, device=dev)
    table, start, stop, gt = args
    n_tiles, q = gt.shape
    outs = [(torch.empty((n_tiles, 9, q), device=dev),
             torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev))
            for _ in range(2)]
    pairs = torch.zeros(1, dtype=torch.int64, device=dev)
    render.launch_render_fwd(table, start, stop, gt, *outs[0], **ckw,
                             pairs=pairs)
    render.launch_render_fwd(table, start, stop, gt, *outs[1], **ckw)
    torch.cuda.synchronize()
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    t_final, ncon, nval = outs[0][0][:, 7], outs[0][1][:, 0], outs[0][1][:, 1]
    px_mask = render.pixel_coords(n_tiles, ckw["tiles_x"], 32, 32,
                                  ckw["height"], ckw["width"], dev)[2]
    seg = (stop - start).to(torch.int64)[:, None]
    walked = torch.where(t_final >= 1e-2, seg,
                         torch.minimum(ncon.to(torch.int64) + 1, seg))
    walked = int(torch.where(px_mask, walked, torch.zeros_like(walked)).sum())
    contribs = int(nval.to(torch.int64).sum())
    assert 0 < contribs <= int(pairs) < walked


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("tile", [(16, 16), (32, 32), (12, 20)])
def test_render_jvp_primal_equals_render_fwd(dev, tile, full):
    """On the dense scene of the backward's tests (12,000 Gaussians, ~10%
    of the pixels terminating), render_jvp's primal outputs equal
    render_fwd's bit for bit: the two kernels cull differently but take the
    same contributing pairs, in segment order, with the same expressions."""
    args, ckw = core_inputs(tile, p=BWD_SCENES["dense"], device=dev)
    g = torch.Generator().manual_seed(7)
    tans = torch.randn(args[0].shape[0], (6 if full else 3) * 6,
                       generator=g).to(dev)
    out, _ = render.core_fwd_jvp(args[0], tans, *args[1:], **ckw, full=full)
    fwd = render.core_fwd(*args, **ckw)
    torch.cuda.synchronize()
    assert float((fwd.t_final < 1e-2).float().mean()) > 0.01
    for f in out._fields:
        assert torch.equal(getattr(out, f), getattr(fwd, f)), f


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
    a = scatter_sum(keys.to(dev), vals.to(dev), ivals.to(dev), 300)
    b = scatter_sum(keys, vals, ivals, 300)
    # both sum each key's values in input order: bit-equal
    assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1])


def scatter_inputs(tile, seed, device):
    """Per-pixel (midx, ucross) as strided views of [T, 3, Q] and [T, 9, Q]
    buffers (as the forward's out_i[:, 2] and out_f[:, 8]), on tiles whose
    segments run from empty to longer than the tile's pixels, with pixels
    that name no instance, long runs of one instance, and a budget tail."""
    g = torch.Generator().manual_seed(seed)
    n_tiles, q = 40, tile[0] * tile[1]
    lengths = torch.randint(0, 60, (n_tiles,), generator=g)
    lengths[::7] = 0
    lengths[3::9] = 3000  # segments longer than a tile's pixels
    stop = torch.cumsum(lengths, 0).to(torch.int32)
    start = (stop - lengths).to(torch.int32)
    n_inst = int(stop[-1]) + 500
    out_i = torch.randint(-5, 5, (n_tiles, 3, q), generator=g,
                          dtype=torch.int32)
    out_f = torch.randn(n_tiles, 9, q, generator=g)
    for t in range(n_tiles):
        ln = int(lengths[t])
        if ln == 0:
            out_i[t, 2] = -1
            continue
        # a few instances named by many pixels, the rest by a few
        hot = torch.randint(0, min(ln, 4), (q,), generator=g)
        cold = torch.randint(0, ln, (q,), generator=g)
        pick = torch.rand(q, generator=g)
        local = torch.where(pick < 0.5, hot, cold)
        out_i[t, 2] = torch.where(pick < 0.9, int(start[t]) + local,
                                  torch.full_like(local, -1)).to(torch.int32)
    return (out_i.to(device), out_f.to(device), start.to(device),
            stop.to(device), n_inst)


@pytest.mark.parametrize("tile", [(16, 16), (32, 32), (8, 16)])
def test_tile_scatter_sum_matches_plain(dev, tile):
    """Bit-equal to its plain version on the CPU (index_add_ in pixel
    order), reading midx and ucross in place from strided views; every
    instance no pixel names, the gaps and the tail included, reads 0.
    Tiles whose pixels name at most 32 distinct instances take one pass
    of the kernel's counting sort, the others several."""
    out_i, out_f, start, stop, n_inst = scatter_inputs(tile, 3, dev)
    distinct = [len(set(r.tolist()) - {-1}) for r in out_i[:, 2].cpu()]
    assert min(distinct) <= 32 < max(distinct)
    before = render.launches["tile_scatter_sum"]
    u, npix = render.tile_scatter_sum(out_i[:, 2], out_f[:, 8], start, stop,
                                      n_inst)
    torch.cuda.synchronize()
    assert render.launches["tile_scatter_sum"] == before + 1
    want = render.tile_scatter_sum_reference(
        out_i[:, 2].cpu(), out_f[:, 8].cpu(), start.cpu(), stop.cpu(),
        n_inst)
    assert torch.equal(u.cpu(), want[0]) and torch.equal(npix.cpu(), want[1])
    assert int(want[1].max()) > 100 and int(want[1].sum()) > 0
    again = render.tile_scatter_sum(out_i[:, 2], out_f[:, 8], start, stop,
                                    n_inst)
    assert torch.equal(u, again[0]) and torch.equal(npix, again[1])


@pytest.mark.parametrize("tile", [(16, 16), (32, 32)])
def test_tile_scatter_sum_on_the_forward(dev, tile):
    """On the forward kernel's own midx and ucross, over a scene whose
    32x32 tiles hold segments longer than their 1024 pixels: bit-equal to
    the plain version on the CPU, and core_fwd's u_inst / npix_inst are
    the kernel's."""
    args, ckw = core_inputs(tile, p=12000, device=dev)
    table, start, stop, gt = args
    n_tiles, q = gt.shape
    out_f = torch.empty((n_tiles, 9, q), device=dev)
    out_i = torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev)
    render.launch_render_fwd(table, start, stop, gt, out_f, out_i, **ckw)
    u, npix = render.tile_scatter_sum(out_i[:, 2], out_f[:, 8], start, stop,
                                      table.shape[0])
    want = render.tile_scatter_sum_reference(
        out_i[:, 2].cpu(), out_f[:, 8].cpu(), start.cpu(), stop.cpu(),
        table.shape[0])
    assert torch.equal(u.cpu(), want[0]) and torch.equal(npix.cpu(), want[1])
    if tile == (32, 32):
        assert int((stop - start).max()) > q
    out = render.core_fwd(*args, **ckw)
    assert torch.equal(out.u_inst, u) and torch.equal(out.npix_inst, npix)


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


def bwd_inputs(tile, device, seed=0, p=3000):
    """The forward on ``device`` (the kernel on the card) and random
    cotangents from a seeded generator."""
    args, ckw = core_inputs(tile, p=p, device=device)
    fwd = render.core_fwd(*args, **ckw)
    t, q = fwd.depth.shape
    g = torch.Generator().manual_seed(seed)
    cots = tuple(torch.randn(s, generator=g).to(device) for s in
                 [(t, 3, q), (t, q), (t, q), (t, q), (t, q), (t, q)])
    totals = (fwd.color, fwd.depth, fwd.weight, fwd.var, fwd.t_final)
    return args, ckw, fwd, totals, cots


# scenes of the backward's card tests: 3,000 Gaussians on 96x160, where
# almost no pixel terminates, and 12,000, where ~10% do and segments run
# past 1,024 instances; in both most pixels' last contributor comes before
# their segment's end, so the n_contrib stop and the culling both act
BWD_SCENES = {"sparse": 3000, "dense": 12000}


@pytest.mark.parametrize("scene", list(BWD_SCENES))
@pytest.mark.parametrize("tile", [(8, 16), (16, 16), (32, 32)])
@pytest.mark.parametrize("want", [(True, True), (False, False)])
def test_render_bwd_matches_plain(dev, tile, want, scene):
    args, ckw, fwd, totals, cots = bwd_inputs(tile, dev, p=BWD_SCENES[scene])
    table, start, stop, gt = args
    kw = dict(ckw, want_med=want[0], want_var=want[1])
    before = render.launches["render_bwd"]
    k = render.core_bwd(table, start, stop, gt, totals, cots, **kw,
                        n_contrib=fwd.n_contrib)
    torch.cuda.synchronize()
    assert render.launches["render_bwd"] == before + 1
    seg = (stop - start)[:, None]
    assert float((fwd.n_contrib < seg).float().mean()) > 0.5
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
    again = render.core_bwd(table, start, stop, gt, totals, cots, **kw,
                            n_contrib=fwd.n_contrib)
    assert torch.equal(k, again)


@pytest.mark.parametrize("tile", [(16, 16), (32, 32), (8, 8), (12, 20)])
def test_render_bwd_stop_and_culling_change_no_row(dev, tile):
    """Stopping each pixel at its last contributor (the forward's
    n_contrib) and culling by box give the rows of a walk of the whole
    segment (an n_contrib of INT_MAX, which the kernel clips to the
    segment), bit for bit; the counter build changes no row and tests
    fewer pairs than the pixels walk, and fewer still with the stop."""
    args, ckw, fwd, totals, cots = bwd_inputs(tile, dev, p=12000)
    table, start, stop, gt = args
    pix = render.blend.bwd_pixel_inputs(gt, *totals, *cots).contiguous()
    outs, tested = [], []
    whole = torch.full_like(fwd.n_contrib, torch.iinfo(torch.int32).max)
    for ncon in (fwd.n_contrib, whole):
        for count in (False, True):
            rows = torch.zeros((table.shape[0], render.ROW), device=dev)
            pairs = torch.zeros(1, dtype=torch.int64, device=dev) \
                if count else None
            render.launch_render_bwd(table, start, stop, pix, rows, **ckw,
                                     n_contrib=ncon, pairs=pairs)
            outs.append(rows)
            if count:
                tested.append(int(pairs))
    torch.cuda.synchronize()
    for rows in outs[1:]:
        assert torch.equal(rows, outs[0])
    n_tiles, q = gt.shape
    px_mask = render.pixel_coords(n_tiles, ckw["tiles_x"], tile[0], tile[1],
                                  ckw["height"], ckw["width"], dev)[2]
    seg = (stop - start).to(torch.int64)[:, None]
    walked = torch.where(fwd.t_final >= 1e-2, seg,
                         torch.minimum(fwd.n_contrib.to(torch.int64) + 1,
                                       seg))
    walked = int(torch.where(px_mask, walked, torch.zeros_like(walked)).sum())
    contribs = int(fwd.n_valid.to(torch.int64).sum())
    assert contribs <= tested[0] < tested[1] < walked


@pytest.mark.parametrize("tile", [(32, 32), (16, 16), (8, 16), (24, 32),
                                  (16, 64), (12, 20), (30, 30)])
def test_render_bwd_pixel_map_matches_mirror(dev, tile):
    """The kernels' own pixel map (blend_common.cuh's patch_pixel, which
    render_fwd and render_bwd share) equals render.bwd_pixel_map's CPU
    mirror, which test_torch_tile_scatter.py holds to owning every tile
    pixel exactly once."""
    k = render.bwd_pixel_map(*tile, device=dev).cpu()
    assert torch.equal(k, render.bwd_pixel_map(*tile))


@pytest.mark.parametrize("f,offset", [(12, 0), (2, 0), (12, 1), (5, 0)])
def test_segment_sum_rows_matches_plain(dev, f, offset):
    """The kernel adds each run in order: bit-equal to index_add_ on the
    CPU, which adds in the same order.  Runs empty, longer than the
    kernel's prefetch depth, and clipped by the budget; F = 12 with its
    16-byte loads, F = 2, and the plain loop's cases (rows at an offset of
    one float, F = 5)."""
    g = torch.Generator().manual_seed(f + offset)
    p, cap = 5000, 20000
    lengths = torch.randint(0, 10, (p,), generator=g)
    lengths[::97] = 23
    ends = torch.cumsum(lengths, 0).clamp_max(cap)
    assert int(torch.cumsum(lengths, 0)[-1]) > cap
    start = (ends - lengths).clamp(0, cap).to(torch.int32)
    stop = ends.to(torch.int32)
    rows = torch.randn(cap * f + offset, generator=g)[offset:].view(cap, f)
    inv = torch.randperm(cap, generator=g).to(torch.int32)
    rows_d = torch.randn(cap * f + offset, generator=g).to(dev)
    rows_d[offset:] = rows.reshape(-1).to(dev)
    rows_d = rows_d[offset:].view(cap, f)
    before = render.launches["segment_sum_rows"]
    before_f = render.row_launches.get(f, 0)
    a = segment_sum_rows(rows_d, *(x.to(dev) for x in (inv, start, stop)))
    torch.cuda.synchronize()
    assert render.launches["segment_sum_rows"] == before + 1
    assert render.row_launches[f] == before_f + 1
    b = segment_sum_rows_reference(rows, inv, start, stop)
    assert torch.equal(a.cpu(), b)


def scene_grads(device, seed=13, basis=False, dtype=torch.float32):
    """Gradients of every output through rasterize on ``device`` (the
    scene made on the CPU and moved, its floats to ``dtype``); ``basis``
    sets ``splat_basis_power``."""
    means, kw, cam = small_scene(p=200, h=40, w=56, seed=seed, sh_degree=1,
                                 device="cpu")
    cfg = RasterConfig(tile_h=8, tile_w=8, chunk=16, ref_depth_var=False,
                       splat_basis_power=basis)
    to = lambda v: v.to(device, dtype) if v.is_floating_point() \
        else v.to(device)
    leaves = {"means3D": means, **{k: kw[k] for k in
              ("scales", "rotations", "opacities", "shs")}}
    leaves = {k: to(v).requires_grad_(True) for k, v in leaves.items()}
    view = to(cam.viewmatrix).requires_grad_(True)
    rest = {k: (to(v) if torch.is_tensor(v) else v)
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
    render.reset_launches()
    a = scene_grads(dev)
    b = scene_grads(dev)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert render.launches["render_bwd"] == 2
    # per step one for the forward's uncertainty sums (F = 2), one for the
    # rows (F = 12)
    assert render.launches["segment_sum_rows"] == 4
    assert render.row_launches == {2: 2, 12: 2}


@pytest.mark.parametrize("alpha_grad", [True, False])
def test_api_bit_equal_to_rasterize(dev, alpha_grad):
    """``GaussianRasterizer`` on the card: outputs and gradients bit-equal
    to ``rasterize``'s on the same inputs and loss (without its silhouette
    term when ``alpha_grad`` is off), with ``rasterize``'s launches: one
    render_fwd, tile_scatter_sum and render_bwd and two segment_sum_rows
    (F = 2 and 12) per forward + backward."""
    from diff_gaussian_rasterization_tpu_torch import (
        GaussianRasterizationSettings, GaussianRasterizer)
    means, kw, cam = small_scene(p=200, h=40, w=56, seed=3, sh_degree=1,
                                 device=dev)
    cfg = RasterConfig(tile_h=8, tile_w=16, chunk=16)
    names = ("means3D", "scales", "rotations", "opacities", "shs")

    def leaves():
        d = {k: (means if k == "means3D" else kw[k]).detach().clone()
             .requires_grad_(True) for k in names}
        d["means2D"] = torch.zeros(200, 3, device=dev, requires_grad=True)
        d["viewmatrix"] = cam.viewmatrix.detach().clone().requires_grad_(True)
        return d

    def loss(color, depth, median, var, alpha, w_alpha):
        return (color.sum() + 0.3 * depth.sum() + 0.15 * median.sum()
                + 0.1 * var.sum() + w_alpha * alpha.sum())

    a = leaves()
    settings = GaussianRasterizationSettings(
        image_height=40, image_width=56, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=kw["bg"], scale_modifier=1.0,
        viewmatrix=a["viewmatrix"], sh_degree=1)
    render.reset_launches()
    out = GaussianRasterizer(settings, cfg, alpha_grad=alpha_grad)(
        **a, gt_depth=kw["gt_depth"])
    loss(out[0], out[2], out[3], out[4], out[5], 0.2).backward()
    torch.cuda.synchronize()
    counts, rows = dict(render.launches), dict(render.row_launches)
    assert counts == dict(counts, render_fwd=1, tile_scatter_sum=1,
                          render_bwd=1, segment_sum_rows=2)
    assert rows == {2: 1, 12: 1}

    b = leaves()
    ref = ras.rasterize(
        b["means3D"], cam.replace(viewmatrix=b["viewmatrix"]), cfg,
        means2D=b["means2D"][:, :2], sh_degree=1, bg=kw["bg"],
        gt_depth=kw["gt_depth"],
        **{k: b[k] for k in names if k != "means3D"})
    loss(ref.color, ref.depth, ref.depth_median, ref.depth_var,
         ref.opacity_map, 0.2 if alpha_grad else 0.0).backward()
    for x, y in zip(out, ref[:8]):
        assert torch.equal(x, y)
    for k in a:
        assert torch.equal(a[k].grad, b[k].grad), k
    assert not a["means2D"].grad[:, 2].any()
    assert a["means2D"].grad[:, :2].any()


def jvp_inputs(tile, k_t, full, device, seed=0, color=False):
    """A small scene's sorted table and binning, and a seeded tangent
    table [I, per_k * K] (the same rows for the card and the CPU; per_k 9
    with the colour columns)."""
    args, ckw = core_inputs(tile, device=device)
    per_k = render.tangent_columns(full, color)
    g = torch.Generator().manual_seed(seed)
    tans = torch.randn(args[0].shape[0], per_k * k_t, generator=g)
    ckw = dict(ckw, full=full, color=True) if color else dict(ckw, full=full)
    return args, tans.to(device), ckw


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


def check_render_jvp(dev, tile, k_t, full, color=False):
    args, tans, ckw = jvp_inputs(tile, k_t, full, dev, color=color)
    before = render.launches["render_jvp"]
    out, tan = render.core_fwd_jvp(args[0], tans, *args[1:], **ckw)
    torch.cuda.synchronize()
    # one launch per group of at most JVP_GROUP tangents
    groups = -(-k_t // render.JVP_GROUP)
    assert render.launches["render_jvp"] == before + groups
    assert tan.color.shape[1] == k_t
    p_out, p_tan = render.core_fwd_jvp_reference(args[0], tans, *args[1:],
                                                 **ckw)
    assert_core_close(out, p_out)
    assert_tangents_close(tan, p_tan, out, p_out)
    assert float(tan.color.abs().max()) > 0
    # the primal is render_fwd's, bit for bit
    fwd = render.core_fwd(*args, **{k: v for k, v in ckw.items()
                                    if k not in ("full", "color")})
    for f in out._fields:
        assert torch.equal(getattr(out, f), getattr(fwd, f)), f
    again = render.core_fwd_jvp(args[0], tans, *args[1:], **ckw)
    for x, y in zip(tan, again[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("k_t,full", [(6, False), (6, True), (1, False),
                                      (1, True)])
@pytest.mark.parametrize("tile", [(8, 16), (32, 32)])
def test_render_jvp_matches_plain(dev, tile, k_t, full):
    check_render_jvp(dev, tile, k_t, full)


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("k_t", [1, 3, 6, 8])
@pytest.mark.parametrize("tile", [(8, 16), (32, 32)])
def test_render_jvp_colour_matches_plain(dev, tile, k_t, full):
    """The colour branch's instantiation (PER_K = 9: the conic's columns,
    then dr, dg, db) against the plain core, with and without
    ``full`` (the conic columns are taken either way), in one launch and
    in two (K = 8)."""
    check_render_jvp(dev, tile, k_t, full, color=True)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("k_t", [2, 3, 4, 5, 8, 10])
@pytest.mark.parametrize("tile", [(8, 8), (32, 32)])
def test_render_jvp_other_k_matches_plain(dev, tile, k_t, full):
    """Every K, not only the twist basis's 6: K <= 6 in one launch, K = 8
    and 10 in two (6 + 2 and 6 + 4 columns, the primal from the first)."""
    check_render_jvp(dev, tile, k_t, full)


def random_splats(n, alpha_min, seed):
    """Splats of every shape the culling box must hold: scales from 0.05
    to 12 px, aspect ratios up to 240 at any angle (nearly degenerate
    conics), opacities from exactly ``alpha_min`` and a few ulps above it
    to 1, centers at integer and fractional pixels."""
    rng = np.random.RandomState(seed)
    sx = np.exp(rng.uniform(np.log(0.05), np.log(12.0), n))
    sy = np.exp(rng.uniform(np.log(0.05), np.log(12.0), n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cov = np.stack([[c * c * sx ** 2 + s * s * sy ** 2,
                     c * s * (sx ** 2 - sy ** 2)],
                    [c * s * (sx ** 2 - sy ** 2),
                     s * s * sx ** 2 + c * c * sy ** 2]]).transpose(2, 0, 1)
    conic = np.linalg.inv(cov)
    conic = np.stack([conic[:, 0, 0], conic[:, 0, 1], conic[:, 1, 1]], 1)
    am = np.float32(alpha_min)
    op = np.where(rng.uniform(size=n) < 0.5,
                  am * (1 + rng.choice([0, 1e-7, 1e-6, 1e-4, 1e-2], n)),
                  rng.uniform(am, 1.0, n)).astype(np.float32)
    xy = np.where(rng.uniform(size=(n, 1)) < 0.3,
                  np.round(rng.uniform(20, 44, (n, 2))),
                  rng.uniform(20, 44, (n, 2)))
    return (torch.as_tensor(xy.astype(np.float32)),
            torch.as_tensor(conic.astype(np.float32)), torch.as_tensor(op))


def contributing_pixels(xy, conic, op, cfg, size=64):
    """[N, size, size] mask of the pixels of a size x size grid where a
    splat's alpha reaches ``alpha_min`` by the per-pair test of
    render_jvp.cu, in its float32 expressions; and the pixel coordinates
    px [1, size, 1], py [1, 1, size]."""
    grid = torch.arange(size, dtype=torch.float32)
    px, py = grid[None, :, None], grid[None, None, :]
    dx = xy[:, 0, None, None] - px
    dy = xy[:, 1, None, None] - py
    a, b, c = (conic[:, i, None, None] for i in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(op[:, None, None] * torch.exp(power),
                            cfg.alpha_cap)
    return (power <= 0) & (alpha >= cfg.alpha_min), px, py


def boxes_agree(k, m, ulps=8):
    """Culling boxes [N, 4] (x0, x1, y0, y1): the same infinities, and
    finite edges within ``ulps`` float32 ulps of the larger edge of their
    axis (the card's logf and the CPU's log may round differently)."""
    axis = torch.stack([m[:, 0:2].abs().amax(1), m[:, 2:4].abs().amax(1)], 1)
    unit = axis.repeat_interleave(2, 1) * 2.0 ** -23
    fin = torch.isfinite(m)
    if not (torch.equal(torch.isfinite(k), fin)
            and torch.equal(k[~fin], m[~fin])):
        return False
    return bool(((k - m).abs()[fin] <= ulps * unit[fin]).all())


def test_render_jvp_cull_boxes_hold_every_contributing_pixel(dev):
    """The kernel's own culling box (``cull_box``, through
    ``render.cull_boxes``) contains every pixel where the blend's float32
    alpha reaches ``alpha_min``, and equals the box of its CPU mirror
    ``render.cull_extent``, which ``test_torch_render_jvp.py`` holds to the
    same pixels: the two copies of the box cannot drift apart."""
    cfg = RasterConfig()
    xy, conic, op = random_splats(3000, cfg.alpha_min, seed=5)
    table = torch.zeros(xy.shape[0], render.FEAT)
    table[:, 0:2], table[:, 2:5], table[:, 5] = xy, conic, op
    box = render.cull_boxes(table.to(dev), cfg.alpha_min).cpu()
    hits, px, py = contributing_pixels(xy, conic, op, cfg)
    x0, x1, y0, y1 = (box[:, i, None, None] for i in range(4))
    inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
    assert int(hits.sum()) > 10000
    assert not bool((hits & ~inside).any())
    assert boxes_agree(box, render.cull_boxes(table, cfg.alpha_min))


def test_render_jvp_rejects_bad_tangent_table(dev):
    args, tans, ckw = jvp_inputs((8, 8), 2, False, dev)
    with pytest.raises(ValueError):
        render.core_fwd_jvp(args[0], tans[:, :5].contiguous(), *args[1:],
                            **ckw)
    with pytest.raises(ValueError):
        render.core_fwd_jvp(args[0], tans.double(), *args[1:], **ckw)


def test_render_jvp_culls_pairs(dev):
    """The kernel tests fewer (instance, pixel) pairs than the pixels'
    segments hold, and counting them changes no output."""
    args, tans, ckw = jvp_inputs((32, 32), 6, False, dev)
    table, start, stop, gt = args
    n_tiles, q = gt.shape
    outs = [(torch.empty((n_tiles, 9, q), device=dev),
             torch.empty((n_tiles, 3, q), dtype=torch.int32, device=dev),
             torch.empty((n_tiles, 6, 6, q), device=dev)) for _ in range(2)]
    pairs = torch.zeros(1, dtype=torch.int64, device=dev)
    kw = {k: v for k, v in ckw.items() if k != "full"}
    render.launch_render_jvp(table, tans, start, stop, gt, *outs[0], **kw,
                             pairs=pairs)
    render.launch_render_jvp(table, tans, start, stop, gt, *outs[1], **kw)
    torch.cuda.synchronize()
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    px_mask = render.pixel_coords(n_tiles, ckw["tiles_x"], 32, 32,
                                  ckw["height"], ckw["width"], dev)[2]
    walked = int(((stop - start).to(torch.int64)[:, None] * px_mask).sum())
    assert 0 < int(pairs) < walked


# ---- the kernels on a run of the image's tiles (tile0) -------------------


def band_of(args, rank, n):
    """Rank ``rank`` of ``n``'s run of tiles of a binning's tile arrays
    (``parallel.sharded``'s split) and its first tile."""
    from diff_gaussian_rasterization_tpu_torch.parallel import sharded
    table, start, stop, gt = args
    tile0, count = sharded.tile_share(start.shape[0], n, rank)
    band = tuple(sharded.local_tiles(x, tile0, count)
                 for x in (start, stop, gt))
    return (table,) + band, tile0


@pytest.mark.parametrize("tile", [(8, 16), (32, 32), (12, 20)])
def test_render_kernels_at_tile0_match_plain(dev, tile):
    """``render_fwd``, ``render_bwd`` and ``render_jvp`` on a band of tiles
    that starts past tile 0 (``tile0 > 0``) against their plain versions
    on that band."""
    args, ckw, fwd, totals, cots = bwd_inputs(tile, dev, p=12000)
    band, tile0 = band_of(args, 1, 2)
    assert tile0 > 0
    k = render.core_fwd(*band, tile0=tile0, **ckw)
    p = render.core_fwd_reference(*band, tile0=tile0, **ckw)
    torch.cuda.synchronize()
    assert_core_close(k, p)
    assert int((k.midx >= 0).sum()) > 0
    from diff_gaussian_rasterization_tpu_torch.parallel import sharded
    count = band[1].shape[0]
    btot = (k.color, k.depth, k.weight, k.var, k.t_final)
    bcot = tuple(sharded.local_tiles(c, tile0, count) for c in cots)
    rows_k = render.core_bwd(*band, btot, bcot, n_contrib=k.n_contrib,
                             tile0=tile0, **ckw)
    pix = render.blend.bwd_pixel_inputs(band[3], *btot, *bcot).contiguous()
    rows_p = render.core_bwd_reference(*band[:3], pix, tile0=tile0, **ckw)
    tile_ok = (k.n_contrib == p.n_contrib).all(dim=1)
    assert float((~tile_ok).float().mean()) < 0.05
    start, stop = band[1].to(torch.int64), band[2].to(torch.int64)
    owned = torch.zeros(rows_k.shape[0], dtype=torch.bool, device=dev)
    for t in torch.nonzero(tile_ok).flatten().tolist():
        owned[start[t]:stop[t]] = True
    torch.testing.assert_close(rows_k[owned], rows_p[owned], rtol=1e-3,
                               atol=2e-4)
    assert float(rows_k[owned].abs().max()) > 0
    g = torch.Generator().manual_seed(1)
    tans = torch.randn(band[0].shape[0], 18, generator=g).to(dev)
    out, tan = render.core_fwd_jvp(band[0], tans, *band[1:], tile0=tile0,
                                   **ckw)
    p_out, p_tan = render.core_fwd_jvp_reference(band[0], tans, *band[1:],
                                                 tile0=tile0, **ckw)
    assert_core_close(out, p_out)
    assert_tangents_close(tan, p_tan, out, p_out)
    for f in ("color", "depth", "n_contrib", "midx"):
        assert torch.equal(getattr(out, f), getattr(k, f)), f


@pytest.mark.parametrize("n", [2, 3])
def test_render_kernels_on_bands_bit_equal_to_one_launch(dev, n):
    """Every rank's band rendered at its ``tile0``, put together, is the
    one launch over the whole grid bit for bit (``tile0 = 0`` is that
    launch): the tile-major outputs, the summed per-instance statistics
    and gradient rows, and the dual render's primal and tangents."""
    from diff_gaussian_rasterization_tpu_torch.parallel import sharded
    args, ckw, fwd, totals, cots = bwd_inputs((16, 16), dev, p=12000)
    t = args[1].shape[0]
    rows = render.core_bwd(*args, totals, cots, n_contrib=fwd.n_contrib,
                           **ckw)
    g = torch.Generator().manual_seed(2)
    tans = torch.randn(args[0].shape[0], 18, generator=g).to(dev)
    jout, jtan = render.core_fwd_jvp(args[0], tans, *args[1:], **ckw)
    parts, u, npix, rows_sum, jparts = [], 0, 0, 0, []
    for r in range(n):
        band, tile0 = band_of(args, r, n)
        k = render.core_fwd(*band, tile0=tile0, **ckw)
        parts.append(k)
        u, npix = u + k.u_inst, npix + k.npix_inst
        count = band[1].shape[0]
        bcot = tuple(sharded.local_tiles(c, tile0, count) for c in cots)
        rows_sum = rows_sum + render.core_bwd(
            *band, (k.color, k.depth, k.weight, k.var, k.t_final), bcot,
            n_contrib=k.n_contrib, tile0=tile0, **ckw)
        jparts.append(render.core_fwd_jvp(band[0], tans, *band[1:],
                                          tile0=tile0, **ckw))
    for i, f in enumerate(render.CoreOutputs._fields[:9]):
        whole = torch.cat([getattr(x, f) for x in parts])[:t]
        assert torch.equal(whole, getattr(fwd, f)), f
        jwhole = torch.cat([getattr(x[0], f) for x in jparts])[:t]
        assert torch.equal(jwhole, getattr(jout, f)), f
    for f in render.PoseTangents._fields:
        jwhole = torch.cat([getattr(x[1], f) for x in jparts])[:t]
        assert torch.equal(jwhole, getattr(jtan, f)), f
    assert torch.equal(u, fwd.u_inst) and torch.equal(npix, fwd.npix_inst)
    assert torch.equal(rows_sum, rows)


# ---- the exponent's basis form (splat_basis_power) -----------------------


def basis_kw(ckw):
    return dict(ckw, cfg=ckw["cfg"].replace(splat_basis_power=True))


@pytest.mark.parametrize("tile", [(8, 16), (32, 32), (12, 20)])
def test_render_fwd_basis_matches_plain(dev, tile):
    """``render_fwd``'s basis instantiation against the plain version with
    the basis (the same power bit for bit; the transmittance's products
    round apart as in the direct form), one launch, bit-equal repeats, and
    other bits than the direct instantiation."""
    args, ckw = core_inputs(tile, p=12000, device=dev)
    bkw = basis_kw(ckw)
    before = render.launches["render_fwd"]
    k = render.core_fwd(*args, **bkw)
    torch.cuda.synchronize()
    assert render.launches["render_fwd"] == before + 1
    p = render.core_fwd_reference(*args, **bkw)
    assert_core_close(k, p)
    assert int((k.midx >= 0).sum()) > 0
    again = render.core_fwd(*args, **bkw)
    for x, y in zip(k, again):
        assert torch.equal(x, y)
    direct = render.core_fwd(*args, **ckw)
    assert not torch.equal(direct.color, k.color)


@pytest.mark.parametrize("tile", [(8, 16), (32, 32)])
def test_render_bwd_basis_matches_plain(dev, tile):
    """``render_bwd``'s basis instantiation (stopped at the basis
    forward's ``n_contrib``) against the plain backward with the basis, on
    the tiles whose ``n_contrib`` agrees; bit-equal repeats; culling and
    the stop change no row."""
    args, ckw = core_inputs(tile, p=12000, device=dev)
    bkw = basis_kw(ckw)
    table, start, stop, gt = args
    fwd = render.core_fwd(*args, **bkw)
    t, q = fwd.depth.shape
    g = torch.Generator().manual_seed(0)
    cots = tuple(torch.randn(sh, generator=g).to(dev) for sh in
                 [(t, 3, q), (t, q), (t, q), (t, q), (t, q), (t, q)])
    totals = (fwd.color, fwd.depth, fwd.weight, fwd.var, fwd.t_final)
    before = render.launches["render_bwd"]
    k = render.core_bwd(table, start, stop, gt, totals, cots, **bkw,
                        n_contrib=fwd.n_contrib)
    torch.cuda.synchronize()
    assert render.launches["render_bwd"] == before + 1
    pix = render.blend.bwd_pixel_inputs(gt, *totals, *cots).contiguous()
    p = render.core_bwd_reference(table, start, stop, pix, **bkw)
    plain_fwd = render.core_fwd_reference(*args, **bkw)
    tile_ok = (fwd.n_contrib == plain_fwd.n_contrib).all(dim=1)
    inst_ok = torch.repeat_interleave(tile_ok, (stop - start).to(torch.int64))
    first = int(start[0])
    torch.testing.assert_close(k[first:first + inst_ok.shape[0]][inst_ok],
                               p[first:first + inst_ok.shape[0]][inst_ok],
                               rtol=1e-3, atol=2e-4)
    assert float((~tile_ok).float().mean()) < 0.05
    whole = torch.full_like(fwd.n_contrib, torch.iinfo(torch.int32).max)
    rows = torch.zeros_like(k)
    render.launch_render_bwd(table, start, stop, pix, rows, **bkw,
                             n_contrib=whole)
    assert torch.equal(rows, k)


@pytest.mark.parametrize("n", [2, 3])
def test_render_basis_on_bands_bit_equal_to_one_launch(dev, n):
    """The basis instantiations on every rank's band at its ``tile0``, put
    together, are the one launch bit for bit: the basis is taken about the
    image tile's corner."""
    from diff_gaussian_rasterization_tpu_torch.parallel import sharded
    args, ckw = core_inputs((16, 16), p=12000, device=dev)
    bkw = basis_kw(ckw)
    fwd = render.core_fwd(*args, **bkw)
    t, q = fwd.depth.shape
    g = torch.Generator().manual_seed(3)
    cots = tuple(torch.randn(sh, generator=g).to(dev) for sh in
                 [(t, 3, q), (t, q), (t, q), (t, q), (t, q), (t, q)])
    rows = render.core_bwd(*args, (fwd.color, fwd.depth, fwd.weight,
                                   fwd.var, fwd.t_final), cots,
                           n_contrib=fwd.n_contrib, **bkw)
    parts, rows_sum = [], 0
    for r in range(n):
        band, tile0 = band_of(args, r, n)
        k = render.core_fwd(*band, tile0=tile0, **bkw)
        parts.append(k)
        bcot = tuple(sharded.local_tiles(c, tile0, band[1].shape[0])
                     for c in cots)
        rows_sum = rows_sum + render.core_bwd(
            *band, (k.color, k.depth, k.weight, k.var, k.t_final), bcot,
            n_contrib=k.n_contrib, tile0=tile0, **bkw)
    for f in render.CoreOutputs._fields[:9]:
        whole = torch.cat([getattr(x, f) for x in parts])[:t]
        assert torch.equal(whole, getattr(fwd, f)), f
    assert torch.equal(rows_sum, rows)


def test_basis_culling_skips_no_kept_pair(dev):
    """``render.cull_misses`` on the card: no pair of the binning lies
    outside its tile's basis-form culling box while the blend would keep
    it (nor outside the direct box, for the direct form)."""
    for tile in ((32, 32), (8, 16)):
        args, ckw = core_inputs(tile, p=12000, device=dev)
        table, start, stop, _ = args
        assert render.cull_misses(table, start, stop, **basis_kw(ckw)) == 0
        assert render.cull_misses(table, start, stop, **ckw) == 0


# The card's basis-form gradients against float64, in units of
# 2e-5 + 5e-4 |reference| (the direct test's atol and rtol): at most this.
# Set from the H100's readings on this scene, 1.127 (means3D) and 1.030
# (rotations), the rest <= 0.51, beside the float32 CPU path's 0.874 and
# 0.774 and the direct form's on the card, 1.272 and 1.073 (CHANGES.md).
BASIS_GRAD_LIMIT = 1.5


def test_rasterize_basis_grads_card_match_cpu(dev):
    """The card's gradients with the basis form held to the CPU path in
    float64, as ``chip_smoke.py`` holds the gradient rows: per leaf, the
    card's largest error at most ``BASIS_GRAD_LIMIT`` in units of
    ``2e-5 + 5e-4 |reference|``.  The float32 CPU path's reading, and the
    direct form's on the card against its own float64, are printed beside
    it (``-s``)."""
    ref = scene_grads("cpu", basis=True, dtype=torch.float64)
    cpu = scene_grads("cpu", basis=True)
    card = scene_grads(dev, basis=True)
    ref_d = scene_grads("cpu", dtype=torch.float64)
    card_d = scene_grads(dev)
    ratio = lambda x, r, k: float(((x[k].cpu().double() - r[k]).abs()
                                   / (2e-5 + 5e-4 * r[k].abs())).max())
    for k in ref:
        print(f"gradients against float64, {k}: card basis "
              f"{ratio(card, ref, k):.4f}, CPU float32 basis "
              f"{ratio(cpu, ref, k):.4f}, card direct "
              f"{ratio(card_d, ref_d, k):.4f}")
    for k in ref:
        assert bool(torch.isfinite(card[k]).all()), k
        assert ratio(card, ref, k) <= BASIS_GRAD_LIMIT, (
            k, ratio(card, ref, k), ratio(cpu, ref, k))


# --------------------------------------------------------------------------
# the preprocess kernel pair (ops/kernels/preprocess.py)
# --------------------------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PREP_SCENES = ("replica_500k", "replica_mini", "tum_mini")
# the table's columns by output
PREP_OUTPUTS = dict(xy=slice(0, 2), conic=slice(2, 5), opacity=slice(5, 6),
                    color=slice(6, 9), depth=slice(9, 10),
                    depth_sgview=slice(10, 11))


def prep_scene(name, variant, seed=0):
    """A preprocess scene: float64 numpy leaves (``means2D`` zeros), the
    view, the camera's fields and the config.  ``replica_500k`` is
    ``io/synthetic.py``'s room at wall resolution 240 (499,712 Gaussians)
    from a walkthrough pose at the Replica camera; the fixtures' scenes are
    their first frames back-projected (every pixel) at their poses, with
    the rotations, scales and SH degree 1 jittered so every gradient
    route carries weight."""
    from diff_gaussian_rasterization_tpu_torch.io import replica, synthetic, tum
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        init_model)
    from diff_gaussian_rasterization_tpu_torch.models.runner import (
        add_gaussians, backproject)
    rng = np.random.RandomState(seed)
    if name == "replica_500k":
        model = synthetic.replica_like_model(seed=seed, wall_res=240,
                                             device="cpu")
        view = synthetic.walkthrough_trajectory(
            4, seed=seed, dtype=torch.float64, device="cpu")[1].numpy()
        cam = dict(tanfovx=1.0, tanfovy=680 / 1200, height=680, width=1200)
        cfg = RasterConfig(tile_h=32, tile_w=32)
    else:
        if name == "replica_mini":
            ds = replica.ReplicaDataset(
                os.path.join(FIXTURES, "replica_mini", "office0"),
                device="cpu")
            cfg = RasterConfig(tile_h=16, tile_w=16)
        else:
            ds = tum.TUMDataset(os.path.join(FIXTURES, "tum_mini"),
                                height=60, width=80, fx=57.0, fy=54.0,
                                cx=39.5, cy=29.5, device="cpu")
            cfg = RasterConfig(tile_h=8, tile_w=16)
        view = ds.pose(0).astype(np.float64)
        tmpl = ds.camera_template(torch.as_tensor(ds.pose(0)))
        frame = ds.frame(0)
        model = init_model(ds.height * ds.width, sh_degree=1, device="cpu")
        add_gaussians(model, *backproject(frame, view, tmpl, 1))
        cam = dict(tanfovx=tmpl.tanfovx, tanfovy=tmpl.tanfovy,
                   height=tmpl.height, width=tmpl.width)
    if variant == "full":
        cfg = cfg.full_variant()
    kw = {k: v.detach().double().numpy()
          for k, v in model.raster_kwargs().items() if torch.is_tensor(v)}
    p = kw["scales"].shape[0]
    kw["rotations"] = kw["rotations"] + rng.normal(scale=0.2, size=(p, 4))
    kw["scales"] = kw["scales"] * np.exp(rng.normal(scale=0.2, size=(p, 3)))
    if kw["shs"].shape[1] > 1:
        kw["shs"][:, 1:] = rng.normal(scale=0.2,
                                      size=kw["shs"][:, 1:].shape)
    leaves = dict(means3D=model.means3D.detach().double().numpy(), **kw,
                  means2D=np.zeros((p, 2)))
    deg = int(round(kw["shs"].shape[1] ** 0.5)) - 1
    return leaves, view, cam, cfg, deg


def prep_run(op, leaves, view, cam, cfg, deg, d_feat, dtype, device):
    """``op``'s (prep, table, {leaf: gradient}) at ``dtype`` on ``device``:
    the gradients of <table, d_feat> for every leaf and the view."""
    from diff_gaussian_rasterization_tpu_torch.camera import Camera
    t = {k: torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
         for k, v in {**leaves, "view": view}.items()}
    kw = {k: x for k, x in t.items() if k not in ("means3D", "view")}
    prep, feat = op(t["means3D"], Camera(viewmatrix=t["view"], **cam), cfg,
                    sh_degree=deg, **kw)
    g = torch.autograd.grad(feat, list(t.values()),
                            d_feat.to(device=device, dtype=dtype))
    return prep, feat.detach(), dict(zip(t, g))


def composite_op(*args, **kw):
    from diff_gaussian_rasterization_tpu_torch.ops import projection
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as kp)
    prep = projection.preprocess(*args, **kw)
    return prep, kp.feature_table(prep)


def kernel_op(*args, **kw):
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as kp)
    return kp.preprocess_table(*args, **kw)


def rel_err(x, ref):
    """Largest error over the largest entry of the float64 reference."""
    ref = ref.detach().cpu().double()
    return float((x.detach().cpu().double() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-300))


def near_boundary(leaves, view, cam, cfg, rel=1e-5):
    """[P] bool: a Gaussian whose integer footprint rounds a float64 value
    within ``rel`` (relative, at least absolute) of a rounding boundary:
    the near-plane and live tests, the eigenvalue radius, the opacity cut's
    extents and the rect's four tile quotients (the composite's formulas in
    float64)."""
    from diff_gaussian_rasterization_tpu_torch.camera import Camera
    from diff_gaussian_rasterization_tpu_torch.ops import projection
    t = {k: torch.tensor(v) for k, v in leaves.items()}
    c = Camera(viewmatrix=torch.tensor(view), **cam)
    v = c.viewmatrix
    z = t["means3D"] @ v[:3, 2] + v[3, 2]
    vis = z > cfg.near
    cov3 = projection.compute_cov3d(t["scales"], t["rotations"], 1.0,
                                    cfg.normalize_quaternions)
    a, b, cc = projection.compute_cov2d(
        t["means3D"], cov3, v, c.focal_x, c.focal_y, c.tanfovx, c.tanfovy,
        cfg, valid=vis).unbind(1)
    det = a * cc - b * b
    mid = 0.5 * (a + cc)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, cfg.eig_clamp))
    close = lambda x, to: (x - to).abs() <= rel * torch.clamp_min(
        x.abs(), 1.0)
    on_int = lambda x: close(x, torch.round(x))
    out = close(z, torch.full_like(z, cfg.near)) | on_int(
        cfg.radius_sigma * torch.sqrt(lam))
    radius = torch.ceil(cfg.radius_sigma * torch.sqrt(lam))
    rx = ry = radius
    if cfg.opacity_cull:
        ratio = t["opacities"].reshape(-1) / cfg.alpha_min
        cut = torch.clamp_max(torch.sqrt(2.0 * torch.log(
            torch.clamp_min(ratio, 1.0))), cfg.radius_sigma)
        ex = cut * torch.sqrt(torch.clamp_min(a, 0.0)) + 1e-3
        ey = cut * torch.sqrt(torch.clamp_min(cc, 0.0)) + 1e-3
        out |= close(ratio, torch.ones_like(ratio)) | on_int(ex) | on_int(ey)
        rx, ry = torch.ceil(ex), torch.ceil(ey)
    xy = projection.preprocess(t["means3D"], c, cfg, **{
        k: x for k, x in t.items() if k != "means3D"}).xy
    for s in (-1.0, 1.0):
        out |= on_int((xy[:, 0] + s * rx) / cfg.tile_w)
        out |= on_int((xy[:, 1] + s * ry) / cfg.tile_h)
    return out


@pytest.mark.parametrize("variant", ["light", "full"])
@pytest.mark.parametrize("scene", PREP_SCENES)
def test_preprocess_kernel_matches_float64(dev, scene, variant):
    """The kernel pair against the composite in float64 on the CPU: each
    output and each leaf's gradient (the view matrix's included) no
    further off than twice the float32 composite's on the card, or than
    2**-22 of the largest entry (one or two float32 ulps, where both are
    at float32's resolution and their ratio is noise); the
    integer footprint and the mask equal to the float64 composite's but
    where a value lies within 1e-5 of a rounding boundary."""
    leaves, view, cam, cfg, deg = prep_scene(scene, variant)
    g = torch.Generator().manual_seed(5)
    d_feat = torch.randn((leaves["means3D"].shape[0], 11), generator=g,
                         dtype=torch.float64)
    ref = prep_run(composite_op, leaves, view, cam, cfg, deg, d_feat,
                   torch.float64, "cpu")
    comp = prep_run(composite_op, leaves, view, cam, cfg, deg, d_feat,
                    torch.float32, dev)
    kern = prep_run(kernel_op, leaves, view, cam, cfg, deg, d_feat,
                    torch.float32, dev)
    floor = 2.0 ** -22
    for name, cols in PREP_OUTPUTS.items():
        ek = rel_err(kern[1][:, cols], ref[1][:, cols])
        ec = rel_err(comp[1][:, cols], ref[1][:, cols])
        print(f"{scene}/{variant} {name}: kernel {ek:.3g}, composite "
              f"{ec:.3g}")
        assert ek <= max(2.0 * ec, floor), (name, ek, ec)
    for k in ref[2]:
        ek, ec = rel_err(kern[2][k], ref[2][k]), rel_err(comp[2][k],
                                                         ref[2][k])
        print(f"{scene}/{variant} d {k}: kernel {ek:.3g}, composite {ec:.3g}")
        assert ek <= max(2.0 * ec, floor), (k, ek, ec)
        assert bool(torch.isfinite(kern[2][k]).all()), k
    edge = near_boundary(leaves, view, cam, cfg)
    ints = ("mask", "radius", "rect_min", "rect_max", "tiles_touched")
    bad = torch.zeros_like(edge)
    for f in ints:
        a, b = getattr(kern[0], f).cpu(), getattr(ref[0], f)
        diff = a != b
        bad |= diff if diff.dim() == 1 else diff.any(1)
    print(f"{scene}/{variant}: {int(edge.sum())} of {edge.shape[0]} "
          f"Gaussians near a rounding boundary, {int(bad.sum())} integer "
          f"footprints differ, {int((bad & ~edge).sum())} of them away "
          f"from a boundary")
    assert not bool((bad & ~edge).any())


def test_preprocess_backward_bit_reproducible(dev):
    """Two backward runs, the view matrix's gradient (a sum over P in
    per-block partials) included, are bit-equal."""
    leaves, view, cam, cfg, deg = prep_scene("replica_500k", "full")
    d_feat = torch.randn((leaves["means3D"].shape[0], 11),
                         generator=torch.Generator().manual_seed(6),
                         dtype=torch.float64)
    a = prep_run(kernel_op, leaves, view, cam, cfg, deg, d_feat,
                 torch.float32, dev)
    b = prep_run(kernel_op, leaves, view, cam, cfg, deg, d_feat,
                 torch.float32, dev)
    assert torch.equal(a[1], b[1])
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k
    assert float(a[2]["view"].abs().max()) > 0


def test_preprocess_launches_once_a_render(dev):
    """``preprocess_fwd`` once a render, ``preprocess_bwd`` once a
    backward (with or without the view's gradient), once a binning, and
    the dual render's primal through it too, its tangents through
    ``preprocess_tangents`` once; a CUDA tensor the kernel does not take
    raises."""
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as kp)
    from diff_gaussian_rasterization_tpu_torch.models import lie
    means, kw, cam = small_scene(p=300, h=40, w=56, seed=3, sh_degree=1,
                                 device=dev)
    cfg = RasterConfig(tile_h=8, tile_w=8)
    leaves = {k: kw[k].clone().requires_grad_(True)
              for k in ("scales", "rotations", "opacities", "shs")}
    view = cam.viewmatrix.clone().requires_grad_(True)
    rest = {k: v for k, v in kw.items() if k not in leaves}
    for track_off in (True, False):
        kp.reset_launches()
        out = ras.rasterize(means, cam.replace(viewmatrix=view), cfg,
                            track_off=track_off, **leaves, **rest)
        assert kp.launches == {"preprocess_fwd": 1, "preprocess_bwd": 0,
                               "preprocess_tangents": 0}
        (out.color.sum() + out.depth.sum()).backward()
        assert kp.launches == {"preprocess_fwd": 1, "preprocess_bwd": 1,
                               "preprocess_tangents": 0}
        assert (view.grad is None) == track_off
    kp.reset_launches()
    binn = ras.bin_for_view(means, cam, cfg, **leaves, **rest)
    tw = torch.func.jacfwd(lambda x: lie.apply_twist(cam.viewmatrix, x))(
        torch.zeros(6, device=dev)).movedim(-1, 0)
    ras.rasterize_with_pose_jvp(means, cam, cfg, tw, binn=binn,
                                **{k: v.detach() for k, v in leaves.items()},
                                **rest)
    assert kp.launches == {"preprocess_fwd": 2, "preprocess_bwd": 0,
                           "preprocess_tangents": 1}
    with pytest.raises(ValueError):
        ras.rasterize(means.double(), cam, cfg, **{
            k: v.detach().double() for k, v in leaves.items()}, **rest)


# the tangent table's quantities, a tangent's columns in order
TANGENT_COLUMNS = ("dx", "dy", "ddepth", "dA", "dB", "dC", "dr", "dg", "db")


def twist_tangents(view):
    from diff_gaussian_rasterization_tpu_torch.models import lie
    return torch.func.jacfwd(lambda x: lie.apply_twist(view, x))(
        torch.full((6,), 1e-3, dtype=view.dtype,
                   device=view.device)).movedim(-1, 0)


def composite_tangents(means, cam, cfg, tw, kw):
    """The composite's forward mode, the oracle the tangents are held to:
    [P, per_k * K]."""
    from diff_gaussian_rasterization_tpu_torch.ops import projection
    full = bool(cfg.pose_cov2d_branch)
    color = ras.color_branch(cfg, **kw)

    def feats(vm):
        pv = projection.preprocess(means, cam.replace(viewmatrix=vm), cfg,
                                   **kw)
        return (pv.xy, pv.depth) + ((pv.conic,) if full or color else ()) \
            + ((pv.color,) if color else ())

    t = torch.func.vmap(lambda d: torch.func.jvp(
        feats, (cam.viewmatrix,), (d,))[1])(tw)
    return torch.cat([t[0], t[1][..., None], *t[2:]], -1).movedim(
        0, 1).reshape(means.shape[0], -1)


def column_errors(x, ref, k_t):
    """Each column's largest error over its quantity's largest entry in
    ``ref`` (over the K tangents; a tangent whose column is zero in exact
    arithmetic has only rounding noise of its own): [K, per_k]."""
    p = ref.shape[0]
    ref = ref.detach().double()
    err = (x.detach().double() - ref).abs().reshape(p, k_t, -1).amax(0)
    scale = ref.abs().reshape(p, k_t, -1).amax((0, 1))
    return err / scale.clamp_min(1e-300)


def assert_tangents_within(kern, comp, ref, k_t, tag):
    """The kernel's error against ``ref`` (float64) no larger, column for
    column, than twice the float32 composite's or 2**-22 (the measure of
    ``test_preprocess_kernel_matches_float64``); returns the worst ratio."""
    ek, ec = column_errors(kern, ref, k_t), column_errors(comp, ref, k_t)
    limit = torch.clamp(2.0 * ec, min=2.0 ** -22)
    per_k = ek.shape[1]
    for j in range(per_k):
        print(f"{tag} {TANGENT_COLUMNS[j]}: kernel "
              f"{float(ek[:, j].max()):.3g}, composite "
              f"{float(ec[:, j].max()):.3g}")
    assert bool((ek <= limit).all()), (tag, ek / limit)
    assert bool(torch.isfinite(kern).all()), tag
    return float((ek / limit).max())


def tangent_scene(name, variant, dev, seed=0):
    """``prep_scene``'s scene with its leaves as float32 and float64 CUDA
    tensors; ``full_sh3`` adds SH bands 1-3 (deviation 0.25, as the
    replica-full-sh3 configuration) to the full variant."""
    leaves, view, cam, cfg, deg = prep_scene(
        name, "light" if variant == "light" else "full", seed)
    if variant == "full_sh3":
        p = leaves["shs"].shape[0]
        rng = np.random.RandomState(seed + 1)
        shs = rng.normal(scale=0.25, size=(p, 16, 3))
        shs[:, 0] = leaves["shs"][:, 0]
        leaves["shs"], deg = shs, 3
    from diff_gaussian_rasterization_tpu_torch.camera import Camera
    out = {}
    for dt in (torch.float32, torch.float64):
        t = {k: torch.tensor(v, dtype=dt, device=dev)
             for k, v in leaves.items() if k != "means2D"}
        c = Camera(viewmatrix=torch.tensor(view, dtype=dt, device=dev),
                   **cam)
        out[dt] = (t.pop("means3D"), c, dict(t, sh_degree=deg))
    return out, cfg


@pytest.mark.parametrize("variant", ["light", "full", "full_sh3"])
@pytest.mark.parametrize("scene", PREP_SCENES)
def test_preprocess_tangents_match_float64(dev, scene, variant):
    """``preprocess_tangents`` (the kernel) against the composite's forward
    mode and against ``preprocess_tangents_reference``, both in float64 on
    the card: each column's error over its quantity's largest entry no
    larger than twice the float32 composite's own, or 2**-22; the layout
    (per_k columns a tangent) as ``render.tangent_columns`` gives it."""
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as kp)
    data, cfg = tangent_scene(scene, variant, dev)
    m32, c32, kw32 = data[torch.float32]
    m64, c64, kw64 = data[torch.float64]
    tw64 = twist_tangents(c64.viewmatrix)
    tw32 = tw64.float()
    color = ras.color_branch(cfg, **kw32)
    assert color == (variant != "light" and kw32["sh_degree"] >= 1)
    per_k = render.tangent_columns(bool(cfg.pose_cov2d_branch), color)
    kp.reset_launches()
    kern = kp.preprocess_tangents(m32, c32, cfg, tw32, **kw32)
    assert kp.launches["preprocess_tangents"] == 1
    assert kern.shape == (m32.shape[0], per_k * 6)
    comp = composite_tangents(m32, c32, cfg, tw32, kw32)
    ref = composite_tangents(m64, c64, cfg, tw64, kw64)
    ref_cf = kp.preprocess_tangents_reference(m64, c64, cfg, tw64, **kw64)
    tag = f"{scene}/{variant}"
    assert_tangents_within(kern, comp, ref, 6, tag)
    assert_tangents_within(kern, comp, ref_cf, 6, tag + " (closed form)")


@pytest.mark.parametrize("k_t", [1, 7, 13])
def test_preprocess_tangents_any_k(dev, k_t):
    """Any K: the twist basis and random directions beyond it, past the
    kernel's chunk of 6 tangents, each column within the same tolerance
    against the composite in float64; the first six columns' tangents
    bit-equal to a K = 6 call's."""
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as kp)
    data, cfg = tangent_scene("tum_mini", "full_sh3", dev)
    m32, c32, kw32 = data[torch.float32]
    m64, c64, kw64 = data[torch.float64]
    g = torch.Generator(device=dev).manual_seed(k_t)
    tw64 = torch.cat([twist_tangents(c64.viewmatrix), 0.1 * torch.randn(
        (max(k_t - 6, 0), 4, 4), generator=g, dtype=torch.float64,
        device=dev)])[:k_t]
    tw32 = tw64.float()
    kern = kp.preprocess_tangents(m32, c32, cfg, tw32, **kw32)
    comp = composite_tangents(m32, c32, cfg, tw32, kw32)
    ref = composite_tangents(m64, c64, cfg, tw64, kw64)
    assert kern.shape == (m32.shape[0], 9 * k_t)
    assert_tangents_within(kern, comp, ref, k_t, f"K={k_t}")
    six = kp.preprocess_tangents(m32, c32, cfg, tw32[:6], **kw32)
    n = 9 * min(k_t, 6)
    assert torch.equal(kern[:, :n], six[:, :n])


def test_pose_jvp_tables_keep_the_composite_tangents(dev):
    """``rasterize_with_pose_jvp``'s tangent table on the card (now the
    ``preprocess_tangents`` kernel's) is the composite's forward-mode
    derivative column for column, within the kernel's tolerance against
    the float64 composite (twice the float32 composite's error or
    2**-22), in the same layout and gather; its primal table (the
    kernel's) is the composite's to float32 rounding; both repeat bit for
    bit.  At SH 1 the full variant carries the colour branch: per tangent
    the conic's columns and then the colour's (9 columns)."""
    from diff_gaussian_rasterization_tpu_torch.ops import projection
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as kp)
    means, kw, cam = small_scene(p=300, h=40, w=56, seed=4, sh_degree=1,
                                 device=dev)
    prep_kw = {k: kw[k] for k in ("scales", "rotations", "opacities", "shs",
                                  "sh_degree")}
    kw64 = {k: (v.double() if torch.is_tensor(v) else v)
            for k, v in prep_kw.items()}
    cam64 = cam.replace(viewmatrix=cam.viewmatrix.double())
    for cfg in (RasterConfig(tile_h=8, tile_w=8),
                RasterConfig(tile_h=8, tile_w=8).full_variant()):
        full = bool(cfg.pose_cov2d_branch)
        color = ras.color_branch(cfg, **prep_kw)
        assert color == full
        tw = twist_tangents(cam.viewmatrix)
        with torch.no_grad():
            prep, binn, table, tans, _ = ras.pose_jvp_tables(
                means, cam, cfg, tw, None, kw["gt_depth"], **prep_kw)
            again = ras.pose_jvp_tables(
                means, cam, cfg, tw, None, kw["gt_depth"], **prep_kw)
            want = composite_tangents(means, cam, cfg, tw,
                                      prep_kw)[binn.gauss_id]
            want64 = composite_tangents(means.double(), cam64, cfg,
                                        tw.double(), kw64)[binn.gauss_id]
            comp = kp.feature_table(projection.preprocess(
                means, cam, cfg, **prep_kw))[binn.gauss_id]
        assert tans.shape[1] == 6 * (9 if color else 3)
        assert_tangents_within(tans, want, want64, 6,
                               "full" if full else "light")
        assert torch.equal(again[3], tans) and torch.equal(again[2], table)
        torch.testing.assert_close(table, comp, rtol=1e-5, atol=1e-5)


def test_preprocess_tangents_launch_once_a_dual_render(dev):
    """A tracked frame launches ``preprocess_tangents`` once a dual render
    (K = 6: as often as ``render_jvp``), and with tracing on
    ``render.gaussians`` counts the Gaussians of every ``preprocess_fwd``
    and ``preprocess_tangents`` launch; a CUDA tensor the kernel does not
    take raises."""
    from diff_gaussian_rasterization_tpu_torch.models.slam import track_frame
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import (
        preprocess as kp)
    from diff_gaussian_rasterization_tpu_torch.scenes import tracking_frame
    from diff_gaussian_rasterization_tpu_torch.utils import profiling
    ts = tracking_frame(p=3000, device=dev)
    track_frame(ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg, ts.camera)
    torch.cuda.synchronize()
    kp.reset_launches()
    render.reset_launches()
    profiling.reset()
    with profiling.recording():
        track_frame(ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg,
                    ts.camera)
        c = profiling.snapshot()["counters"]
    profiling.reset()
    duals = render.launches["render_jvp"]
    assert duals > 0
    assert kp.launches["preprocess_tangents"] == duals
    p = ts.model.means3D.shape[0]
    assert c["render.gaussians"] == (kp.launches["preprocess_fwd"]
                                     + duals) * p
    means, kw, cam = small_scene(p=64, h=24, w=32, seed=2, sh_degree=1,
                                 device=dev)
    prep_kw = {k: kw[k] for k in ("scales", "rotations", "opacities", "shs",
                                  "sh_degree")}
    tw = twist_tangents(cam.viewmatrix)
    cfg = RasterConfig(tile_h=8, tile_w=8)
    with pytest.raises(ValueError):
        kp.preprocess_tangents(means, cam, cfg, tw[:, :3], **prep_kw)
    with pytest.raises(ValueError):
        kp.preprocess_tangents(means, cam, cfg, tw.double(), **prep_kw)
