"""The port's render core against the JAX package's.

``core_fwd_reference`` (the plain PyTorch version of the CUDA kernel) is
held against ``tile_xla.core_fwd_xla`` and once against the Pallas kernel
``render_pallas.core_fwd`` in interpret mode, on the same instance stream
(the JAX package's 128-aligned binning of ``test_pallas_kernels.setup()``'s
scene), at the tolerances of ``test_pallas_kernels.py``: float fields
rtol 1e-4 / atol 2e-5, integer fields a mismatch fraction below 5e-3 (the
prefix products round differently, so pixels exactly on a threshold may
flip).  The CUDA kernel is held against the plain version on the same
stream on the card; that test skips without one (``test_torch_cuda.py``
holds the rest of the card's tests, free of JAX).
"""

import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.ops import tile_xla
from diff_gaussian_rasterization_tpu.ops.binning import bin_gaussians
from diff_gaussian_rasterization_tpu.ops.kernels import render_pallas
from diff_gaussian_rasterization_tpu.ops.projection import preprocess
from diff_gaussian_rasterization_tpu.ops.tiling import grid_dims, img_to_tiles
from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
from diff_gaussian_rasterization_tpu_torch.ops.kernels.segment_sum import (
    scatter_sum)

from scenes import make_scene

torch.set_num_threads(2)


def setup(tile=(8, 16), chunk=8, p=48, h=24, w=32, seed=13, capacity=1024):
    """The JAX core's inputs (aligned instance stream) and the same stream
    as the port's [I, 11] feature table."""
    cfg = JaxConfig(tile_h=tile[0], tile_w=tile[1], chunk=chunk)
    scene, cam = make_scene(p=p, h=h, w=w, seed=seed)
    prep = preprocess(
        scene["means3D"], cam, cfg, opacities=scene["opacities"],
        scales=scene["scales"], rotations=scene["rotations"],
        colors_precomp=scene["colors_precomp"])
    tiles_x, tiles_y = grid_dims(h, w, cfg.tile_h, cfg.tile_w)
    binn = bin_gaussians(prep, tiles_x, tiles_y, capacity, align=128)
    ids = binn.gauss_id
    args = (prep.xy[ids], prep.conic[ids], prep.opacity[ids],
            prep.color[ids], prep.depth[ids], prep.depth_sgview[ids])
    gt_tiles = img_to_tiles(scene["gt_depth"], cfg.tile_h, cfg.tile_w)
    jkw = dict(cfg=cfg, tiles_x=tiles_x, capacity=capacity, height=h,
               width=w)
    table = torch.as_tensor(np.concatenate(
        [np.asarray(args[0]), np.asarray(args[1]),
         np.asarray(args[2])[:, None], np.asarray(args[3]),
         np.asarray(args[4])[:, None], np.asarray(args[5])[:, None]], 1))
    t = lambda x: torch.as_tensor(np.array(x))
    port = dict(table=table, tile_start=t(binn.tile_start),
                tile_stop=t(binn.tile_stop), gt_tiles=t(gt_tiles))
    tkw = dict(cfg=RasterConfig(tile_h=tile[0], tile_w=tile[1], chunk=chunk),
               tiles_x=tiles_x, height=h, width=w)
    return args, binn, gt_tiles, jkw, port, tkw


def assert_core_close(a, b, rtol=1e-4, atol=2e-5):
    for name in render.CoreOutputs._fields:
        x = np.asarray(getattr(a, name))
        y = getattr(b, name).cpu().numpy()
        assert x.shape == y.shape, name
        if x.dtype == np.int32:
            frac = np.mean(x != y)
            print(f"{name}: integer mismatch fraction {frac}")
            assert frac < 5e-3, (name, frac)
        else:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("tile,chunk", [((8, 16), 8), ((8, 8), 16)])
def test_reference_matches_core_fwd_xla(tile, chunk):
    args, binn, gt, jkw, port, tkw = setup(tile=tile, chunk=chunk)
    a = tile_xla.core_fwd_xla(*args, binn.tile_start, binn.tile_stop, gt,
                              tile_batch=4, **jkw)
    b = render.core_fwd_reference(**port, **tkw)
    assert_core_close(a, b)
    assert int((b.n_valid > 0).sum()) > 0 and int((b.midx >= 0).sum()) > 0


def test_reference_matches_pallas_interpret():
    args, binn, gt, jkw, port, tkw = setup(chunk=128)
    a = render_pallas.core_fwd(*args, binn.tile_start, binn.tile_stop, gt,
                               interpret=True, **jkw)
    b = render.core_fwd(**port, **tkw)  # CPU tensors: the plain version
    assert_core_close(a, b)


def test_reference_chunk_invariance():
    """Chunk 8 against chunk 128: the chunking regroups the prefix products
    and the sums (a few float32 ulps), and changes nothing else."""
    _, _, _, _, port, tkw = setup(chunk=8)
    a = render.core_fwd_reference(**port, **tkw)
    b = render.core_fwd_reference(
        **port, **dict(tkw, cfg=tkw["cfg"].replace(chunk=128)))
    for name in render.CoreOutputs._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.int32:
            assert torch.equal(x, y), name
        else:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_scatter_sum_sorted_segments_equal_index_add():
    """The card's deterministic reduction (stable sort + segment sums) and
    ``index_add_`` agree bit for bit on the CPU, where both add in input
    order; keys outside [0, n) are dropped."""
    rng = np.random.RandomState(0)
    keys = torch.as_tensor(rng.randint(-1, 40, 500))
    vals = torch.as_tensor(rng.normal(size=500).astype(np.float32))
    ivals = torch.as_tensor(rng.randint(0, 3, 500).astype(np.int32))
    a = scatter_sum(keys, vals, ivals, 37)
    b = render.scatter_sum_reference(keys, vals, ivals, 37)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(8, 16), (8, 8)])
def test_cuda_kernel_matches_reference(tile):
    _need_cuda()
    _, _, _, _, port, tkw = setup(tile=tile)
    dev = torch.device("cuda")
    gpu = {k: v.to(dev).contiguous() for k, v in port.items()}
    before = render.launches["render_fwd"]
    a = render.core_fwd(**gpu, **tkw)
    torch.cuda.synchronize()
    assert render.launches["render_fwd"] == before + 1
    b = render.core_fwd_reference(**port, **tkw)
    assert_core_close(b, a)
    again = render.core_fwd(**gpu, **tkw)
    for x, y in zip(a, again):
        assert torch.equal(x, y)
