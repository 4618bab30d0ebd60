"""The port's binning against the JAX package's, bit for bit.

One preprocess (the JAX package's, converted to torch) feeds both
``bin_gaussians``: the port's unaligned form must equal the JAX
``align=1`` form in every field, and the sort-domain fields
(``gauss_sorted``, ``sort_start``, ``sort_stop``) of the JAX ``align=128``
form.  The overflow case pins what is dropped when the budget is exceeded.
"""

import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.ops.binning import (
    bin_gaussians as jax_bin, default_max_instances as jax_default_max)
from diff_gaussian_rasterization_tpu.ops.projection import (
    preprocess as jax_preprocess)
from diff_gaussian_rasterization_tpu.ops.tiling import grid_dims
from diff_gaussian_rasterization_tpu_torch.ops.binning import (
    bin_gaussians, default_max_instances)
from diff_gaussian_rasterization_tpu_torch.ops.projection import Preprocessed

from scenes import make_scene

torch.set_num_threads(2)


def setup(seed, tile, p=48, h=24, w=32):
    """``test_pallas_kernels.setup()``'s scene: the JAX preprocess and its
    torch copy."""
    scene, cam = make_scene(p=p, h=h, w=w, seed=seed)
    cfg = JaxConfig(tile_h=tile[0], tile_w=tile[1])
    prep = jax_preprocess(
        scene["means3D"], cam, cfg, opacities=scene["opacities"],
        scales=scene["scales"], rotations=scene["rotations"],
        colors_precomp=scene["colors_precomp"])
    tprep = Preprocessed(*(torch.as_tensor(np.array(x)) for x in prep))
    tiles_x, tiles_y = grid_dims(h, w, cfg.tile_h, cfg.tile_w)
    return prep, tprep, tiles_x, tiles_y, cfg


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("tile", [(8, 16), (8, 8)])
@pytest.mark.parametrize("seed", [13, 4])
def test_binning_matches_jax(seed, tile, cull):
    prep, tprep, tx, ty, cfg = setup(seed, tile)
    cap = 1024
    kw = dict(tile_w=cfg.tile_w, tile_h=cfg.tile_h) if cull else {}
    a = jax_bin(prep, tx, ty, cap, align=1, **kw)
    b = bin_gaussians(tprep, tx, ty, cap, **kw)
    for name in ("gauss_id", "tile_id", "valid", "tile_start", "tile_stop",
                 "num_rendered", "overflow"):
        np.testing.assert_array_equal(np_(getattr(a, name)),
                                      np_(getattr(b, name)), err_msg=name)
    assert not bool(b.overflow) and int(b.valid.sum()) > 0
    # the sort-domain fields of the 128-aligned form the fused TPU path reads
    c = jax_bin(prep, tx, ty, cap, align=128, **kw)
    np.testing.assert_array_equal(np_(c.gauss_sorted), np_(b.gauss_id))
    np.testing.assert_array_equal(np_(c.sort_start), np_(b.tile_start))
    np.testing.assert_array_equal(np_(c.sort_stop), np_(b.tile_stop))


def _pairs(binn):
    """The (gaussian, tile) pairs of the valid instances."""
    valid = np_(binn.valid)
    return set(zip(np_(binn.gauss_id)[valid].tolist(),
                   np_(binn.tile_id)[valid].tolist()))


def test_overflow_drops_the_enumeration_tail():
    """Over budget, binning keeps exactly the instances whose position in
    the Gaussian-major, row-major enumeration is below the budget: the tail
    of the highest-index Gaussians goes, whatever its depth."""
    prep, tprep, tx, ty, cfg = setup(13, (8, 8), p=64, h=32, w=40)
    kw = dict(tile_w=cfg.tile_w, tile_h=cfg.tile_h)
    total = int(tprep.tiles_touched.sum())
    cap = total // 2
    a = jax_bin(prep, tx, ty, cap, align=1, **kw)
    b = bin_gaussians(tprep, tx, ty, cap, **kw)
    for name in ("gauss_id", "tile_id", "valid", "tile_start", "tile_stop"):
        np.testing.assert_array_equal(np_(getattr(a, name)),
                                      np_(getattr(b, name)), err_msg=name)
    assert bool(b.overflow) and bool(a.overflow)
    assert int(b.num_rendered) == int(a.num_rendered) == total

    kept = _pairs(b)
    live = _pairs(bin_gaussians(tprep, tx, ty, 2 * total, **kw))
    tt = np_(tprep.tiles_touched).astype(np.int64)
    starts = np.cumsum(tt) - tt
    rmin, rmax = np_(tprep.rect_min), np_(tprep.rect_max)

    def enum_index(g, t):
        x, y = t % tx, t // tx
        rw = max(rmax[g, 0] - rmin[g, 0], 1)
        return starts[g] + (y - rmin[g, 1]) * rw + (x - rmin[g, 0])

    expected = {k for k in live if enum_index(*k) < cap}
    assert kept == expected
    # not a depth rule: some dropped instance lies in front of a kept one
    depth = np_(tprep.depth)
    dropped = live - expected
    assert dropped
    assert min(depth[g] for g, _ in dropped) < max(depth[g] for g, _ in kept)


def test_default_max_instances_matches_jax():
    for p, m in [(1, 8), (100, 8), (100_000, 8), (777, 3)]:
        assert default_max_instances(p, m) == jax_default_max(p, m)
