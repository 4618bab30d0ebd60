"""The port's backward core and gradient-row reduction against the JAX
package's.

``core_bwd_reference`` (the plain version of the ``render_bwd`` CUDA
kernel) is held against ``tile_xla.core_bwd_xla`` on the same aligned
instance stream and random cotangents as
``test_pallas_kernels.test_pallas_bwd_matches_xla``, at its tolerances
(rtol 1e-3 / atol 2e-4: the JAX version reconstructs the per-instance sums
from pixel moments, the port sums them directly).  The plain version of
``segment_sum_rows`` is held against the JAX package's ``segment_sum_rows``
(the Pallas kernel in interpret mode) on random runs, and the port's
binning extras (``inv``, ``gauss_start``/``gauss_stop``) against the JAX
``align=128`` binning.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.ops import tile_xla
from diff_gaussian_rasterization_tpu.ops.binning import (
    bin_gaussians as jax_bin)
from diff_gaussian_rasterization_tpu.ops.kernels import segment_sum as jax_seg
from diff_gaussian_rasterization_tpu_torch.ops import blend
from diff_gaussian_rasterization_tpu_torch.ops.binning import bin_gaussians
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
from diff_gaussian_rasterization_tpu_torch.ops.kernels.segment_sum import (
    segment_sum_rows, segment_sum_rows_reference)

from test_torch_binning import setup as binning_setup
from test_torch_render_fwd import setup as core_setup

torch.set_num_threads(2)


def cotangents(t, q, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            [(t, 3, q), (t, q), (t, q), (t, q), (t, q), (t, q)]]


@pytest.mark.parametrize("tile,chunk,want", [
    ((8, 16), 8, (True, True)),
    ((8, 8), 16, (True, True)),
    ((8, 16), 8, (False, False)),
    ((8, 8), 16, (True, False)),
])
def test_reference_matches_core_bwd_xla(tile, chunk, want):
    want_med, want_var = want
    args, binn, gt, jkw, port, tkw = core_setup(tile=tile, chunk=chunk)
    fwd = tile_xla.core_fwd_xla(*args, binn.tile_start, binn.tile_stop, gt,
                                tile_batch=4, **jkw)
    t, q = fwd.depth.shape
    cots = cotangents(t, q)
    totals = (fwd.color, fwd.depth, fwd.weight, fwd.var, fwd.t_final)
    a = tile_xla.core_bwd_xla(*args[:5], binn.tile_start, binn.tile_stop, gt,
                              *totals, *(jnp.asarray(c) for c in cots),
                              tile_batch=4, want_med=want_med,
                              want_var=want_var, **jkw)
    rows = render.core_bwd(
        port["table"], port["tile_start"], port["tile_stop"],
        port["gt_tiles"], tuple(torch.as_tensor(np.array(x)) for x in totals),
        tuple(torch.as_tensor(c) for c in cots), want_med=want_med,
        want_var=want_var, n_contrib=torch.as_tensor(np.array(fwd.n_contrib)),
        **tkw)
    want_rows = np.concatenate(
        [np.asarray(x).reshape(rows.shape[0], -1) for x in a], axis=1)
    assert rows.shape == (port["table"].shape[0], render.ROW)
    for c, name in enumerate(render.ROW_COLUMNS):
        np.testing.assert_allclose(rows[:, c].numpy(), want_rows[:, c],
                                   rtol=1e-3, atol=2e-4, err_msg=name)
    assert float(rows[:, 5].abs().max()) > 0
    if not want_var:
        assert float(rows[:, 10].abs().max()) == 0.0
    if not want_med:
        assert float(rows[:, 11].abs().max()) == 0.0
    else:
        assert float(rows[:, 11].abs().max()) > 0


def test_reference_chunk_invariance():
    """Chunk 8 against chunk 128: only the prefix sums and products
    regroup."""
    args, binn, gt, jkw, port, tkw = core_setup(chunk=8)
    fwd = render.core_fwd(**port, **tkw)
    t, q = fwd.depth.shape
    cots = tuple(torch.as_tensor(c) for c in cotangents(t, q, seed=4))
    totals = (fwd.color, fwd.depth, fwd.weight, fwd.var, fwd.t_final)
    base = (port["table"], port["tile_start"], port["tile_stop"],
            port["gt_tiles"], totals, cots)
    a = render.core_bwd(*base, n_contrib=fwd.n_contrib, **tkw)
    b = render.core_bwd(*base, n_contrib=fwd.n_contrib,
                        **dict(tkw, cfg=tkw["cfg"].replace(chunk=128)))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_bwd_pixel_inputs_fold_the_totals():
    """``tot_all`` is the dot product of the pixel cotangents with the
    forward totals plus t_final * dL_dtf, and pixcot expands (d - gt)^2."""
    rng = np.random.RandomState(2)
    r = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    gt, tot_c, tot_d, tot_w, tot_v, tf = r(5), r(3, 5), r(5), r(5), r(5), r(5)
    dc, dd, dw, dv, dm, dtf = r(3, 5), r(5), r(5), r(5), r(5), r(5)
    pix = blend.bwd_pixel_inputs(gt, tot_c, tot_d, tot_w, tot_v, tf, dc, dd,
                                 dw, dv, dm, dtf)
    assert pix.shape == (blend.PIX_ROWS, 5)
    tot = (dc * tot_c).sum(0) + dd * tot_d + dv * tot_v + dw * tot_w + tf * dtf
    torch.testing.assert_close(pix[8], tot)
    d = r(5)
    feats = torch.stack([d * 0, d * 0, d * 0, d, d * d, torch.ones(5)])
    torch.testing.assert_close((feats * pix[:6]).sum(0),
                               dd * d + dv * (d - gt) ** 2 + dw,
                               rtol=1e-5, atol=1e-5)


def random_runs(seed, p=300, cap=2048, f=12):
    rng = np.random.RandomState(seed)
    lengths = rng.poisson(3.0, p)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    stop = np.minimum(ends, cap).astype(np.int32)
    start = np.minimum(starts, cap).astype(np.int32)
    rows = rng.normal(size=(cap, f)).astype(np.float32)
    inv = rng.permutation(cap).astype(np.int32)
    return rows, inv, start, stop


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_rows_reference_matches_jax(seed):
    rows, inv, start, stop = random_runs(seed)
    # the JAX kernel reads pre-sort rows as [nb, 16, 128] blocks
    rows_u = np.zeros((rows.shape[0], jax_seg.FEAT), np.float32)
    rows_u[:, :rows.shape[1]] = rows[inv]
    blocks = jnp.asarray(rows_u.reshape(-1, 128, jax_seg.FEAT)
                         .transpose(0, 2, 1))
    a = np.asarray(jax_seg.segment_sum_rows(
        blocks, jnp.asarray(start), jnp.asarray(stop), pcap=128,
        interpret=True))[:, :rows.shape[1]]
    t = torch.as_tensor
    b = segment_sum_rows_reference(t(rows), t(inv), t(start), t(stop))
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version on CPU tensors; the CUDA kernel
    # adds each run in the same order, so the card equals this bit for bit
    assert torch.equal(segment_sum_rows(t(rows), t(inv), t(start), t(stop)),
                       b)


def test_segment_sum_rows_sums_in_run_order():
    """Each Gaussian's sum is the left-to-right float32 sum of its run."""
    rows, inv, start, stop = random_runs(3, p=50, cap=256)
    out = segment_sum_rows_reference(*(torch.as_tensor(x) for x in
                                       (rows, inv, start, stop)))
    for g in range(50):
        acc = np.zeros(rows.shape[1], np.float32)
        for j in range(start[g], stop[g]):
            acc = acc + rows[inv[j]]
        np.testing.assert_array_equal(out[g].numpy(), acc)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("tile", [(8, 16), (8, 8)])
def test_binning_extras_match_jax(tile, cull):
    """``gauss_start``/``gauss_stop`` equal the JAX aligned binning's, and
    ``inv`` equals its pre-sort -> slot map taken back to sorted positions
    through the slot -> sorted-position map ``src``."""
    prep, tprep, tx, ty, cfg = binning_setup(13, tile)
    kw = dict(tile_w=cfg.tile_w, tile_h=cfg.tile_h) if cull else {}
    for cap in (1024, int(tprep.tiles_touched.sum()) // 2):
        a = jax_bin(prep, tx, ty, cap, align=128, **kw)
        b = bin_gaussians(tprep, tx, ty, cap, **kw)
        np.testing.assert_array_equal(np.asarray(a.gauss_start),
                                      b.gauss_start.numpy())
        np.testing.assert_array_equal(np.asarray(a.gauss_stop),
                                      b.gauss_stop.numpy())
        np.testing.assert_array_equal(np.asarray(a.src)[np.asarray(a.inv)],
                                      b.inv.numpy())
        # inv inverts the sort: the sorted Gaussian ids read back pre-sort
        # give each Gaussian's own run
        g_pre = b.gauss_id[b.inv.long()]
        for p in range(tprep.tiles_touched.shape[0]):
            s, e = int(b.gauss_start[p]), int(b.gauss_stop[p])
            assert bool((g_pre[s:e] == p).all())
