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
``test_torch_cuda.py``.
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


def test_core_fwd_jvp_rejects_bad_tangent_table():
    _, _, _, _, port, tkw = setup()
    with pytest.raises(ValueError):
        render.core_fwd_jvp_reference(
            port["table"], torch.zeros(port["table"].shape[0], 7),
            port["tile_start"], port["tile_stop"], port["gt_tiles"], **tkw)
