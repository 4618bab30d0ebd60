"""The port's dual render core (forward + K pose tangents) against the JAX
package's, on the CPU.

``blend.blend_chunk_fwd_jvp`` against the JAX ``blend_chunk_fwd_jvp`` over
two chunks (light, with ``tan_conic``, and with a median tangent), and
``core_fwd_jvp_reference`` (the plain version of the ``render_jvp`` CUDA
kernel) against ``tile_xla.core_fwd_jvp_xla`` on the same instance stream
(``test_torch_render_fwd.setup()``'s 128-aligned binning) with seeded
tangents, light and full.  Tolerances: the primal as
``test_pallas_kernels.py`` holds the forward (rtol 1e-4 / atol 2e-5); the
tangents at ``test_pose_jvp_full_variant_pallas_matches_xla``'s rtol 2e-4
/ atol 5e-5.  The dual core's primal equals ``core_fwd_reference``'s bit
for bit.  The card's kernel is held against the plain version in
``test_torch_cuda.py``; here ``render.cull_extent``, the mirror of the
kernel's culling box, is held to the blend's own float32 alpha: it must
contain every pixel a splat contributes to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.ops import blend as jblend
from diff_gaussian_rasterization_tpu.ops import tile_xla
from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.ops import blend
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render

from test_torch_cuda import contributing_pixels, random_splats
from test_torch_render_fwd import assert_core_close, setup

torch.set_num_threads(2)

K = 6


def chunk_inputs(g=24, q=40, k_t=3, seed=3):
    """Two chunks of G instances over Q pixels, with K tangents each."""
    rng = np.random.RandomState(seed)
    f = lambda *s, lo=0.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    px = np.tile(np.arange(8, dtype=np.float32), q // 8)
    py = np.repeat(np.arange(q // 8, dtype=np.float32), 8)
    chunks = []
    for _ in range(2):
        a = f(g, lo=0.3, hi=1.2)
        c = f(g, lo=0.3, hi=1.2)
        b = f(g, lo=-0.2, hi=0.2) * np.sqrt(a * c)
        chunks.append(dict(
            xy=np.stack([f(g, hi=8.0), f(g, hi=q / 8.0)], -1),
            conic=np.stack([a, b, c], -1),
            opacity=f(g, lo=0.3, hi=1.0), color=f(g, 3),
            depth=f(g, lo=1.0, hi=4.0),
            valid=rng.uniform(size=(g, q)) < 0.9,
            tan_xy=rng.normal(size=(k_t, g, 2)).astype(np.float32),
            tan_depth=rng.normal(size=(k_t, g)).astype(np.float32),
            tan_conic=rng.normal(scale=0.1,
                                 size=(k_t, g, 3)).astype(np.float32),
            tan_med=rng.normal(size=(k_t, g)).astype(np.float32)))
    return chunks, px, py, f(q, lo=1.0, hi=4.0)


@pytest.mark.parametrize("variant", ["light", "conic", "median"])
def test_blend_chunk_fwd_jvp_matches_jax(variant):
    chunks, px, py, gt = chunk_inputs()
    cfg = JaxConfig(alpha_cap=0.9)  # some pairs capped
    k_t, q = 3, px.shape[0]
    jc = jblend.init_jvp_carry(q, k_t)
    tc = blend.init_jvp_carry((q,), k_t, device="cpu")
    t = torch.as_tensor
    g = chunks[0]["xy"].shape[0]
    for i, c in enumerate(chunks):
        jkw = dict(tan_conic=tuple(jnp.asarray(c["tan_conic"]))
                   if variant == "conic" else (),
                   tan_depth_med=tuple(jnp.asarray(c["tan_med"]))
                   if variant == "median" else None)
        jc, _, _ = jblend.blend_chunk_fwd_jvp(
            jc, c["xy"], c["conic"], c["opacity"], c["color"], c["depth"],
            c["depth"], tuple(jnp.asarray(c["tan_xy"])),
            tuple(jnp.asarray(c["tan_depth"])), c["valid"], px, py, gt,
            jnp.int32(i * g), cfg, **jkw)
        tc = blend.blend_chunk_fwd_jvp(
            tc, t(c["xy"]), t(c["conic"]), t(c["opacity"]), t(c["color"]),
            t(c["depth"]), t(c["depth"]), t(c["tan_xy"]), t(c["tan_depth"]),
            t(c["valid"]), t(px), t(py), i * g, RasterConfig(alpha_cap=0.9),
            tan_conic=t(c["tan_conic"]) if variant == "conic" else None,
            tan_depth_med=t(c["tan_med"]) if variant == "median" else None)
    assert int(tc.primal.n_valid.sum()) > 0
    for name in ("s", "color", "depth", "weight", "median"):
        want = np.stack([np.asarray(x) for x in getattr(jc, name)])
        np.testing.assert_allclose(getattr(tc, name).numpy(), want,
                                   rtol=2e-4, atol=5e-5, err_msg=name)
    np.testing.assert_allclose(
        blend.finish_t_final_tangent(tc).numpy(),
        np.stack([np.asarray(x) for x in jblend.finish_t_final_tangent(jc)]),
        rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(tc.primal.color.numpy(),
                               np.asarray(jc.primal.color), rtol=1e-5,
                               atol=1e-6)
    assert float(tc.weight.abs().max()) > 0
    if variant == "median":
        assert float(tc.median.abs().max()) > 0


def tangents(n_inst, full, seed=7):
    """Seeded per-instance tangents as the JAX core takes them (K-tuples)
    and as the port's tangent table [I, per_k * K]."""
    rng = np.random.RandomState(seed)
    txy = rng.normal(size=(K, n_inst, 2)).astype(np.float32)
    td = rng.normal(size=(K, n_inst)).astype(np.float32)
    tcn = rng.normal(scale=0.1, size=(K, n_inst, 3)).astype(np.float32)
    cols = [np.concatenate([txy[k], td[k][:, None]]
                           + ([tcn[k]] if full else []), 1) for k in range(K)]
    jax_t = (tuple(jnp.asarray(txy)), tuple(jnp.asarray(td)),
             tuple(jnp.asarray(tcn)) if full else ())
    return jax_t, torch.as_tensor(np.concatenate(cols, 1))


@pytest.mark.parametrize("full", [False, True])
def test_core_fwd_jvp_reference_matches_xla(full):
    args, binn, gt, jkw, port, tkw = setup()
    (txy, td, tcn), tans = tangents(port["table"].shape[0], full)
    a, at = tile_xla.core_fwd_jvp_xla(
        *args, txy, td, binn.tile_start, binn.tile_stop, gt, tile_batch=4,
        tan_conic=tcn, **jkw)
    b, bt = render.core_fwd_jvp_reference(
        port["table"], tans, port["tile_start"], port["tile_stop"],
        port["gt_tiles"], full=full, **tkw)
    assert_core_close(a, b)
    for name in render.PoseTangents._fields:
        want = np.stack([np.asarray(x) for x in getattr(at, name)], 1)
        got = getattr(bt, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5,
                                   err_msg=name)
    assert float(bt.color.abs().max()) > 0
    assert float(bt.median.abs().max()) == 0.0

    # the primal is core_fwd_reference's, bit for bit; on CPU tensors the
    # wrapper runs the plain version
    fwd = render.core_fwd_reference(**port, **tkw)
    for name in render.CoreOutputs._fields:
        assert torch.equal(getattr(b, name), getattr(fwd, name)), name
    c, ct = render.core_fwd_jvp(
        port["table"], tans, port["tile_start"], port["tile_stop"],
        port["gt_tiles"], full=full, **tkw)
    assert all(torch.equal(x, y) for x, y in zip(bt, ct))


def test_cull_extent_holds_every_contributing_pixel():
    """``render.cull_extent`` (the mirror of render_jvp.cu's ``cull_box``)
    contains every pixel where the blend's own float32 alpha reaches
    ``alpha_min``, so the kernel's culling skips no contributing pair."""
    cfg = RasterConfig()
    xy, conic, op = random_splats(3000, cfg.alpha_min, seed=5)
    rx, ry = render.cull_extent(conic, op, cfg.alpha_min)
    hits, px, py = contributing_pixels(xy, conic, op, cfg)
    dx = xy[:, 0, None, None] - px
    dy = xy[:, 1, None, None] - py
    inside = (dx.abs() <= rx[:, None, None]) & (dy.abs() <= ry[:, None, None])
    assert int(hits.sum()) > 10000
    assert not bool((hits & ~inside).any())
    # the box is bounded for every conic short of near-degenerate (its
    # relative slack makes det <= 0 once det < ~1e-4 (A C + B^2)), and,
    # for conics not near that, tight: at most ~1% and 0.02 px beyond the
    # exact ellipse's extent at tau + 1e-4
    cd = conic.double()
    det = cd[:, 0] * cd[:, 2] - cd[:, 1] ** 2
    cond = det / (cd[:, 0] * cd[:, 2] + cd[:, 1] ** 2)
    assert float((cond > 1e-3).double().mean()) > 0.8
    assert bool(torch.isfinite(rx[cond > 1e-3]).all())
    tau = torch.log(op.double() / cfg.alpha_min).clamp_min(0)
    exact = torch.sqrt(2 * (tau + 1e-4) * cd[:, 2] / det)
    tight = cond > 0.05
    assert bool((rx.double()[tight] <= exact[tight] * 1.01 + 0.02).all())
    assert bool((rx >= 0).all())
    rx0, _ = render.cull_extent(conic[:2], op[:2] * 0.5, 1.0)
    assert bool((rx0 == float("-inf")).all())
    rxd, _ = render.cull_extent(torch.tensor([[1.0, 2.0, 1.0]]),
                                torch.tensor([0.9]), cfg.alpha_min)
    assert bool(torch.isinf(rxd).all() and (rxd > 0).all())


def test_cull_boxes_on_the_cpu_are_the_mirror():
    """On a CPU table ``render.cull_boxes`` (the card's check of the
    kernel's own boxes) is ``cull_extent`` around each splat's center, with
    the kernel's empty (inf, -inf) and unbounded (-inf, inf) edges, and it
    holds the same contributing pixels."""
    cfg = RasterConfig()
    xy, conic, op = random_splats(500, cfg.alpha_min, seed=6)
    extra = torch.tensor([[1.0, 2.0, 1.0], [1.0, 0.0, 1.0]])
    conic, op = torch.cat([conic, extra]), torch.cat([op, torch.tensor(
        [0.9, cfg.alpha_min * 0.5])])
    xy = torch.cat([xy, torch.full((2, 2), 30.0)])
    table = torch.zeros(xy.shape[0], render.FEAT)
    table[:, 0:2], table[:, 2:5], table[:, 5] = xy, conic, op
    box = render.cull_boxes(table, cfg.alpha_min)
    rx, ry = render.cull_extent(conic, op, cfg.alpha_min)
    want = torch.stack([xy[:, 0] - rx, xy[:, 0] + rx, xy[:, 1] - ry,
                        xy[:, 1] + ry], 1)
    assert torch.equal(box, want)
    inf = float("inf")
    assert box[-2].tolist() == [-inf, inf, -inf, inf]
    assert box[-1].tolist() == [inf, -inf, inf, -inf]
    hits, px, py = contributing_pixels(xy, conic, op, cfg)
    x0, x1, y0, y1 = (box[:, i, None, None] for i in range(4))
    inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
    assert int(hits.sum()) > 1000
    assert not bool((hits & ~inside).any())


def test_core_fwd_jvp_rejects_bad_tangent_table():
    _, _, _, _, port, tkw = setup()
    with pytest.raises(ValueError):
        render.core_fwd_jvp_reference(
            port["table"], torch.zeros(port["table"].shape[0], 7),
            port["tile_start"], port["tile_stop"], port["gt_tiles"], **tkw)
