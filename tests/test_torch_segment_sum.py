"""``segment_sum_rows`` on ragged runs, and the per-Gaussian uncertainty
sums that ``rasterize`` takes through it, on the CPU.

The plain version (what the wrapper runs on CPU tensors, and what the card's
kernel equals bit for bit) is held against the JAX package's
``segment_sum_rows`` in interpret mode and against a left-to-right float32
loop, for F = 2 (the uncertainty sums) and F = 12 (the gradient rows), on
runs that are empty, longer than the kernel's prefetch depth, or clipped by
the instance budget.  ``rasterize``'s ``gau_uncertainty`` and
``gau_related_pixels`` must equal, bit for bit, the sums they came from
before: a stable sort by Gaussian over the valid instances and
``scatter_sum``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.ops.kernels import segment_sum as jax_seg
from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
from diff_gaussian_rasterization_tpu_torch.ops.binning import (
    default_max_instances)
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
from diff_gaussian_rasterization_tpu_torch.ops.kernels.segment_sum import (
    scatter_sum, segment_sum_rows, segment_sum_rows_reference)

from scenes import make_scene
from test_torch_rasterize import CFG, port_camera, port_config, to_torch

torch.set_num_threads(2)


def ragged_runs(f, seed=0, cap=1024):
    """Runs of every kind the kernel meets: empty, single, longer than its
    prefetch depth of 4 (up to 23 entries), and a tail clipped by the
    budget ``cap`` (the last runs empty or cut short)."""
    rng = np.random.RandomState(seed)
    lengths = np.concatenate([
        rng.choice([0, 0, 1, 2, 3, 4, 5, 7, 8, 9, 13, 23], size=200),
        [17, 0, 6]])
    ends = np.cumsum(lengths)
    assert ends[-1] > cap  # the budget clips the tail
    start = np.minimum(ends - lengths, cap).astype(np.int32)
    stop = np.minimum(ends, cap).astype(np.int32)
    rows = rng.normal(size=(cap, f)).astype(np.float32)
    inv = rng.permutation(cap).astype(np.int32)
    return rows, inv, start, stop


@pytest.mark.parametrize("f", [2, 12])
def test_segment_sum_rows_ragged_runs(f):
    rows, inv, start, stop = ragged_runs(f)
    t = torch.as_tensor
    out = segment_sum_rows_reference(t(rows), t(inv), t(start), t(stop))
    assert out.shape == (start.shape[0], f)
    # the left-to-right float32 sum of each run, bit for bit
    for g in range(start.shape[0]):
        acc = np.zeros(f, np.float32)
        for j in range(start[g], stop[g]):
            acc = acc + rows[inv[j]]
        np.testing.assert_array_equal(out[g].numpy(), acc)
    assert int((stop - start == 0).sum()) > 0 and int((stop - start).max()) > 8
    # the JAX kernel (interpret mode) reads pre-sort rows as [nb, 16, 128]
    # blocks
    rows_u = np.zeros((rows.shape[0], jax_seg.FEAT), np.float32)
    rows_u[:, :f] = rows[inv]
    blocks = jnp.asarray(rows_u.reshape(-1, 128, jax_seg.FEAT)
                         .transpose(0, 2, 1))
    want = np.asarray(jax_seg.segment_sum_rows(
        blocks, jnp.asarray(start), jnp.asarray(stop), pcap=128,
        interpret=True))[:, :f]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrapper runs the plain version on CPU tensors
    assert torch.equal(segment_sum_rows(t(rows), t(inv), t(start), t(stop)),
                       out)


# scenes of tests/scenes.py: the default budget, one that overflows, other
# tiles, and a margin binning whose runs hold culled instances
CASES = {
    "default": dict(),
    "overflow": dict(max_instances=64),
    "tiles_8x16": dict(cfg=dict(tile_w=16, chunk=8)),
    "margin_binning": dict(margin=4.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_uncertainty_sums_equal_the_sorted_scatter(case):
    c = CASES[case]
    cfg = port_config(CFG.replace(**c.get("cfg", {})))
    scene, cam = make_scene(p=96, h=32, w=40, seed=4)
    kw = to_torch({k: v for k, v in scene.items() if k != "means3D"})
    means = torch.as_tensor(np.array(scene["means3D"]))
    tcam = port_camera(cam)
    prep_kw = {k: v for k, v in kw.items() if k not in ("bg", "gt_depth")}
    cap = c.get("max_instances") or default_max_instances(
        means.shape[0], cfg.instance_multiplier)
    binn = None
    if "margin" in c:
        binn = ras.bin_for_view(means, tcam,
                                cfg.replace(bin_margin_px=c["margin"]),
                                max_instances=cap, **prep_kw)
    with torch.no_grad():
        out = ras.rasterize(means, tcam, cfg, max_instances=cap, binn=binn,
                            **kw)
        _, binn, feat, gt_tiles = ras.prepare(means, tcam, cfg, cap,
                                              kw["gt_depth"], binn=binn,
                                              **prep_kw)
        core = render.core_fwd(
            feat[binn.gauss_id].contiguous(), binn.tile_start,
            binn.tile_stop, gt_tiles, cfg=cfg,
            tiles_x=-(-tcam.width // cfg.tile_w), height=tcam.height,
            width=tcam.width)
    keys = torch.where(binn.valid, binn.gauss_id,
                       torch.full_like(binn.gauss_id, -1))
    u, npix = scatter_sum(keys, core.u_inst, core.npix_inst,
                          means.shape[0])
    assert torch.equal(out.gau_uncertainty[:, 0], u)
    assert torch.equal(out.gau_related_pixels[:, 0], npix)
    assert out.gau_related_pixels.dtype == torch.int32
    assert int(npix.sum()) > 0
    assert bool(out.overflow) == (case == "overflow")
    if case == "margin_binning":
        assert int(binn.valid.sum()) < int(binn.num_rendered)
