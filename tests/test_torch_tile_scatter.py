"""The forward's pixel -> instance scatter as a per-tile reduction, and the
backward kernel's pixel map, on the CPU.

``tile_scatter_sum_reference`` (the plain version of the
``tile_scatter_sum`` CUDA kernel, and what the wrapper runs on CPU tensors)
must equal, bit for bit, ``scatter_sum_reference``, the global scatter it
replaces on the render path, on the per-pixel ``(midx, ucross)`` of
``core_fwd_pixels_reference`` over ``tests/scenes.py`` scenes: the port's
binning (the default budget, one that overflows, other tiles, an image
whose edge cuts its last tiles) and the JAX package's 128-aligned binning,
whose segments leave gaps and a long unused tail.  Its ``u_inst`` and
``npix_inst`` are held against the JAX package's ``core_fwd`` (the Pallas
kernel in interpret mode, and ``tile_xla.core_fwd_xla``) at the forward's
tolerances: rtol 1e-4 / atol 2e-5 on the instances whose pixel count
agrees, and a count mismatch fraction below 5e-3 (pixels exactly on the
0.5 crossing may flip).  ``render.bwd_pixel_map``, the mirror of
``render_bwd.cu``'s pixel map, must own every tile pixel exactly once.
"""

import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.ops import tile_xla
from diff_gaussian_rasterization_tpu.ops.kernels import render_pallas
from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render

from scenes import make_scene
from test_torch_rasterize import CFG, port_camera, port_config, to_torch
from test_torch_render_fwd import setup as aligned_setup

torch.set_num_threads(2)


def port_pixels(p=96, h=32, w=40, seed=4, cfg=None, max_instances=None):
    """A tests/scenes.py scene through the port's preprocess and binning,
    and the plain render core's per-pixel outputs and ucross."""
    cfg = port_config(CFG if cfg is None else cfg)
    scene, cam = make_scene(p=p, h=h, w=w, seed=seed)
    kw = to_torch({k: v for k, v in scene.items() if k != "means3D"})
    means = torch.as_tensor(np.array(scene["means3D"]))
    tcam = port_camera(cam)
    prep_kw = {k: v for k, v in kw.items() if k not in ("bg", "gt_depth")}
    cap = max_instances or 8 * p
    with torch.no_grad():
        _, binn, feat, gt_tiles = ras.prepare(means, tcam, cfg, cap,
                                              kw["gt_depth"], **prep_kw)
        table = feat[binn.gauss_id].contiguous()
        pixels, ucross = render.core_fwd_pixels_reference(
            table, binn.tile_start, binn.tile_stop, gt_tiles, cfg=cfg,
            tiles_x=-(-w // cfg.tile_w), height=h, width=w)
    return pixels, ucross, binn.tile_start, binn.tile_stop, cap, cfg


# scenes of tests/scenes.py: the default budget, one that overflows, other
# tiles, and an image whose right and bottom edges cut the last tiles
PORT_CASES = {
    "default": dict(),
    "overflow": dict(max_instances=64),
    "tiles_8x16": dict(cfg=CFG.replace(tile_w=16, chunk=8)),
    "tiles_16x16_cut": dict(cfg=CFG.replace(tile_h=16, tile_w=16),
                            h=40, w=56),
}


def assert_tile_equals_global(midx, ucross, start, stop, n_inst):
    a = render.tile_scatter_sum_reference(midx, ucross, start, stop, n_inst)
    b = render.scatter_sum_reference(midx.reshape(-1), ucross.reshape(-1),
                                     torch.ones_like(midx).reshape(-1),
                                     n_inst)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].dtype == torch.int32 and a[0].shape == (n_inst,)
    # the wrapper runs the plain version on CPU tensors
    c = render.tile_scatter_sum(midx, ucross, start, stop, n_inst)
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    return a


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_tile_scatter_equals_the_global_scatter(case):
    pixels, ucross, start, stop, cap, cfg = port_pixels(**PORT_CASES[case])
    midx = pixels[8]
    u, npix = assert_tile_equals_global(midx, ucross, start, stop, cap)
    # every kind of pixel and instance is there: pixels with no crossing
    # (midx -1, out-of-image pixels among them), named instances, and the
    # budget's tail past the last segment, which reads 0
    assert int((midx < 0).sum()) > 0 and int((midx >= 0).sum()) > 0
    assert int(npix.sum()) == int((midx >= 0).sum())
    last = int(stop[-1])
    if case == "tiles_16x16_cut":
        h, w = 40, 56
        _, _, inside = render.pixel_coords(midx.shape[0], -(-w // 16), 16,
                                           16, h, w, "cpu")
        assert int((~inside).sum()) > 0
        assert bool((midx[~inside] == -1).all())
    if case != "overflow":
        assert last < cap
        assert float(u[last:].abs().max()) == 0.0
        assert int(npix[last:].abs().max()) == 0


def test_tile_scatter_equals_the_global_scatter_on_aligned_segments():
    """The JAX package's 128-aligned instance stream: segments start at
    multiples of 128, so gaps between them and a long tail name no
    instance and read 0."""
    _, binn, _, _, port, tkw = aligned_setup(chunk=8)
    pixels, ucross = render.core_fwd_pixels_reference(**port, **tkw)
    start, stop = port["tile_start"], port["tile_stop"]
    n_inst = port["table"].shape[0]
    u, npix = assert_tile_equals_global(pixels[8], ucross, start, stop,
                                        n_inst)
    inseg = torch.zeros(n_inst, dtype=torch.bool)
    for a, b in zip(start.tolist(), stop.tolist()):
        inseg[a:b] = True
    assert int((~inseg).sum()) > 128
    assert float(u[~inseg].abs().max()) == 0.0
    assert int(npix[~inseg].abs().max()) == 0
    assert int(npix.sum()) > 0


@pytest.mark.parametrize("tile,chunk,jax_core", [
    ((8, 16), 8, "xla"), ((8, 8), 16, "xla"), ((8, 16), 128, "pallas")])
def test_tile_scatter_matches_jax_core_fwd(tile, chunk, jax_core):
    """``u_inst``/``npix_inst`` of the per-tile reduction of the plain
    core's pixels against the JAX package's core (its ``.at[].add``
    scatter, ``render_pallas.py:390``) on the same aligned stream:
    ``tile_xla`` and the Pallas kernel in interpret mode."""
    args, binn, gt, jkw, port, tkw = aligned_setup(tile=tile, chunk=chunk)
    pixels, ucross = render.core_fwd_pixels_reference(**port, **tkw)
    u, npix = render.tile_scatter_sum(pixels[8], ucross, port["tile_start"],
                                      port["tile_stop"],
                                      port["table"].shape[0])
    if jax_core == "xla":
        ref = tile_xla.core_fwd_xla(*args, binn.tile_start, binn.tile_stop,
                                    gt, tile_batch=4, **jkw)
    else:
        ref = render_pallas.core_fwd(*args, binn.tile_start, binn.tile_stop,
                                     gt, interpret=True, **jkw)
    want_u, want_n = np.asarray(ref.u_inst), np.asarray(ref.npix_inst)
    assert want_u.shape == tuple(u.shape)
    same = want_n == npix.numpy()
    assert np.mean(~same) < 5e-3
    np.testing.assert_allclose(u.numpy()[same], want_u[same], rtol=1e-4,
                               atol=2e-5)
    assert int(npix.sum()) > 0


def test_tile_scatter_synthetic_segments():
    """Segments longer than a tile's pixels and empty ones, pixels with
    midx -1, and a midx outside its own tile's segment (which the forward
    never writes: it names no instance), against a left-to-right float32
    loop over the pixels, bit for bit."""
    rng = np.random.RandomState(7)
    n_tiles, q = 6, 64
    lengths = np.array([0, 3, 200, 1, 70, 0])
    stop = np.cumsum(lengths).astype(np.int32)
    start = (stop - lengths).astype(np.int32)
    n_inst = int(stop[-1]) + 40
    midx = np.full((n_tiles, q), -1, np.int32)
    for t in range(n_tiles):
        if lengths[t]:
            pick = rng.uniform(size=q) < 0.8
            midx[t, pick] = start[t] + rng.randint(0, min(lengths[t], 5),
                                                   pick.sum())
    midx[1, 0] = start[2] + 1   # another tile's instance: dropped
    ucross = rng.normal(size=(n_tiles, q)).astype(np.float32)
    u, npix = render.tile_scatter_sum_reference(
        torch.as_tensor(midx), torch.as_tensor(ucross),
        torch.as_tensor(start), torch.as_tensor(stop), n_inst)
    want_u = np.zeros(n_inst, np.float32)
    want_n = np.zeros(n_inst, np.int32)
    for t in range(n_tiles):
        for p in range(q):
            m = midx[t, p]
            if start[t] <= m < stop[t]:
                want_u[m] = want_u[m] + ucross[t, p]
                want_n[m] += 1
    np.testing.assert_array_equal(u.numpy(), want_u)
    np.testing.assert_array_equal(npix.numpy(), want_n)
    assert want_n[start[2] + 1] == int(((midx[2] == start[2] + 1)).sum())


@pytest.mark.parametrize("tile", [(32, 32), (16, 16), (8, 16), (8, 8),
                                  (16, 32), (24, 32), (32, 16), (16, 64),
                                  (12, 20), (30, 30)])
def test_bwd_pixel_map_owns_every_pixel_once(tile):
    """Every pixel of the tile belongs to exactly one (thread, k) of the
    backward kernel, and where the tile divides into 8x4 patches each
    warp's k-th pixels form one 8x4 patch (a 16x8 region of a 32x32
    tile)."""
    th, tw = tile
    q = th * tw
    m = render.bwd_pixel_map(th, tw)
    ppt = m.shape[1]
    assert m.shape[0] == render.BWD_THREADS and ppt in (1, 2, 4)
    assert ppt * render.BWD_THREADS >= q > (ppt // 2) * render.BWD_THREADS
    owned = m[m < q]
    assert torch.equal(torch.sort(owned).values, torch.arange(q))
    assert bool((m <= q).all())
    if tw % 8 or th % 4:
        return
    for w in range(render.BWD_THREADS // 32):
        for k in range(ppt):
            qi = m[w * 32:(w + 1) * 32, k]
            if bool((qi == q).all()):
                continue
            assert bool((qi < q).all())
            x, y = qi % tw, qi // tw
            assert int(x.max() - x.min()) == 7 and int(y.max() - y.min()) == 3
    if tile == (32, 32):
        for w in range(8):
            qi = m[w * 32:(w + 1) * 32].reshape(-1)
            x, y = qi % tw, qi // tw
            assert int(x.max() - x.min()) == 15 and int(y.max() - y.min()) == 7
