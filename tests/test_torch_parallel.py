"""The parallel layer's per-rank pieces against the JAX package, in one
process (no ranks spawned).

- The plain render cores on a band of tiles that starts past tile 0
  (``tile0``) against ``tile_xla``'s cores with the same ``tile_index``,
  at ``test_torch_render_fwd.py``'s, ``test_torch_render_bwd.py``'s and
  ``test_torch_render_jvp.py``'s tolerances.
- ``bin_gaussians_band`` against the JAX package's (``align=1``): the
  same segments bit for bit, each equal to its slice of the full-grid
  binning; ``band_instance_counts`` and ``default_cap_per_shard`` equal
  to the JAX package's.
- Each per-rank body of ``parallel/sharded.py`` run for the 8 ranks of
  ``conftest.py``'s virtual CPU mesh, the collective emulated (ranks'
  rows concatenated, partial sums added in rank order), against the JAX
  package's ``shard_map`` on that mesh: ``gather_visible`` and
  ``scatter_gathered_stats`` (bit for bit), the tile-sharded core forward
  and backward (the port-vs-JAX core tolerances; and bit-equal to the
  port's unsharded core), the keyframe-sharded gradients
  (``test_sharding.py``'s tolerances against the port's one-rank sum,
  the port-vs-JAX ones against the JAX package's) and the edge-sharded
  pose graph (``test_sharding.py``'s atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.models import lie as jlie
from diff_gaussian_rasterization_tpu.ops import binning as jbinning
from diff_gaussian_rasterization_tpu.ops import tile_xla
from diff_gaussian_rasterization_tpu.ops.rasterize import (
    rasterize as jax_rasterize)
from diff_gaussian_rasterization_tpu.parallel import shard_bin as jshard_bin
from diff_gaussian_rasterization_tpu.parallel import sharded as jsharded
from diff_gaussian_rasterization_tpu.parallel.mesh import make_mesh as jmesh
from diff_gaussian_rasterization_tpu_torch.ops import binning
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
from diff_gaussian_rasterization_tpu_torch.ops.rasterize import rasterize
from diff_gaussian_rasterization_tpu_torch.parallel import shard_bin, sharded

from scenes import make_scene
from test_torch_binning import setup as binning_setup
from test_torch_rasterize import CFG, port_camera, port_config, to_torch
from test_torch_render_bwd import cotangents
from test_torch_render_fwd import assert_core_close
from test_torch_render_fwd import setup as core_setup
from test_torch_render_jvp import tangents

torch.set_num_threads(2)

N = 8


def jax_mesh(axis):
    if len(jax.devices()) < N:
        pytest.skip("needs conftest.py's 8-device virtual CPU mesh")
    return jmesh(shape=(N,), axis_names=(axis,))


def t_(x):
    return torch.as_tensor(np.array(x))


# ---- the plain cores at tile0 --------------------------------------------


def band(port, rank, n):
    tile0, count = sharded.tile_share(port["tile_start"].shape[0], n, rank)
    b = {k: sharded.local_tiles(port[k], tile0, count)
         for k in ("tile_start", "tile_stop", "gt_tiles")}
    return dict(b, table=port["table"]), tile0, count


def jax_band(binn, gt, tile0, count):
    sl = slice(tile0, tile0 + count)
    return (binn.tile_start[sl], binn.tile_stop[sl], gt[sl],
            jnp.arange(tile0, tile0 + count, dtype=jnp.int32))


@pytest.mark.parametrize("tile,chunk", [((8, 16), 8), ((8, 8), 16)])
def test_plain_cores_at_tile0_match_jax(tile, chunk):
    args, binn, gt, jkw, port, tkw = core_setup(tile=tile, chunk=chunk)
    b, tile0, count = band(port, 1, 2)
    assert tile0 > 0 and tile0 + count <= port["tile_start"].shape[0]
    ts, tp, g, ti = jax_band(binn, gt, tile0, count)
    a = tile_xla.core_fwd_xla(*args, ts, tp, g, tile_batch=4,
                              tile_index=ti, **jkw)
    p = render.core_fwd_reference(**b, tile0=tile0, **tkw)
    assert_core_close(a, p)
    assert int((p.n_valid > 0).sum()) > 0

    cots = cotangents(count, g.shape[1])
    totals = (a.color, a.depth, a.weight, a.var, a.t_final)
    rows_j = tile_xla.core_bwd_xla(*args[:5], ts, tp, g, *totals,
                                   *(jnp.asarray(c) for c in cots),
                                   tile_batch=4, tile_index=ti, **jkw)
    rows_p = render.core_bwd(
        b["table"], b["tile_start"], b["tile_stop"], b["gt_tiles"],
        tuple(t_(x) for x in totals), tuple(torch.as_tensor(c) for c in cots),
        n_contrib=t_(a.n_contrib), tile0=tile0, **tkw)
    want = np.concatenate([np.asarray(x).reshape(rows_p.shape[0], -1)
                           for x in rows_j], 1)
    np.testing.assert_allclose(rows_p.numpy(), want, rtol=1e-3, atol=2e-4)
    assert float(rows_p.abs().max()) > 0

    (txy, td, _), tans = tangents(port["table"].shape[0], False)
    ja, jt = tile_xla.core_fwd_jvp_xla(*args, txy, td, ts, tp, g,
                                       tile_batch=4, tile_index=ti, **jkw)
    pa, pt = render.core_fwd_jvp_reference(b["table"], tans, b["tile_start"],
                                           b["tile_stop"], b["gt_tiles"],
                                           tile0=tile0, **tkw)
    assert_core_close(ja, pa)
    for name in render.PoseTangents._fields:
        want = np.stack([np.asarray(x) for x in getattr(jt, name)], 1)
        np.testing.assert_allclose(getattr(pt, name).numpy(), want,
                                   rtol=2e-4, atol=5e-5, err_msg=name)


# ---- banded binning ------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3])
def test_bin_gaussians_band_matches_jax_and_full_grid(n):
    jprep, tprep, tiles_x, tiles_y, cfg = binning_setup(13, (8, 8), p=96,
                                                        h=32, w=40)
    cap = 4096
    full = binning.bin_gaussians(tprep, tiles_x, tiles_y, cap,
                                 tile_w=cfg.tile_w, tile_h=cfg.tile_h,
                                 alpha_min=cfg.alpha_min)
    band_rows = -(-tiles_y // n)
    counts = shard_bin.band_instance_counts(tprep, n, band_rows)
    np.testing.assert_array_equal(
        counts.numpy(),
        np.asarray(jshard_bin.band_instance_counts(jprep, n, band_rows)))
    assert int(counts.sum()) == int(tprep.tiles_touched.sum())
    for d in range(n):
        y0 = d * band_rows
        b = binning.bin_gaussians_band(tprep, tiles_x, y0, band_rows, cap,
                                       tile_w=cfg.tile_w, tile_h=cfg.tile_h,
                                       alpha_min=cfg.alpha_min)
        jb = jbinning.bin_gaussians_band(jprep, tiles_x, y0, band_rows, cap,
                                         align=1, tile_w=cfg.tile_w,
                                         tile_h=cfg.tile_h,
                                         alpha_min=cfg.alpha_min)
        np.testing.assert_array_equal(b.tile_start.numpy(),
                                      np.asarray(jb.tile_start))
        np.testing.assert_array_equal(b.tile_stop.numpy(),
                                      np.asarray(jb.tile_stop))
        live = b.valid.numpy() & (b.tile_id.numpy() < b.tile_start.shape[0])
        np.testing.assert_array_equal(b.gauss_id.numpy()[live],
                                      np.asarray(jb.gauss_id)[live])
        assert int(b.num_rendered) == int(counts[d])
        # each tile's segment is the full grid's, bit for bit
        for t in range(min(band_rows, tiles_y - y0) * tiles_x):
            g = y0 * tiles_x + t
            seg = b.gauss_id[b.tile_start[t]:b.tile_stop[t]]
            want = full.gauss_id[full.tile_start[g]:full.tile_stop[g]]
            assert torch.equal(seg, want), (d, t)


def test_default_cap_per_shard_matches_jax():
    for mi, n in ((1024, 1), (234_033, 2), (5000, 4), (100, 8)):
        assert (shard_bin.default_cap_per_shard(mi, n)
                == jshard_bin.default_cap_per_shard(mi, n))


# ---- per-rank bodies against shard_map ------------------------------------


def test_gather_and_scatter_bodies_match_shard_map():
    mesh = jax_mesh("map")
    scene, cam = make_scene(p=128, h=24, w=32, seed=7)
    means = np.array(scene["means3D"])
    means[::5, 2] = -1.0       # some Gaussians behind the near plane
    params = {"means3D": means, "colors": np.asarray(scene["colors_precomp"]),
              "opacities": np.asarray(scene["opacities"])}
    view = np.asarray(cam.viewmatrix)
    budget = 128 // N
    jg, jvalid, jovf, jorder = jsharded.gather_visible(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(view),
        mesh, "map", budget_per_shard=budget, with_order=True)
    parts = [sharded.gather_visible_local(
        {k: t_(v) for k, v in params.items()}, t_(view), r, N,
        budget_per_shard=budget) for r in range(N)]
    for k in params:
        np.testing.assert_array_equal(
            torch.cat([p[0][k] for p in parts]).numpy(), np.asarray(jg[k]),
            err_msg=k)
    valid = torch.cat([p[1] for p in parts])
    order = torch.cat([p[3] for p in parts])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert int(max(p[2] for p in parts)) == int(jovf) == 0
    # a budget below a shard's visible count sets its flag
    small = [sharded.gather_visible_local(
        {k: t_(v) for k, v in params.items()}, t_(view), r, N,
        budget_per_shard=budget // 2)[2] for r in range(N)]
    assert any(bool(f) for f in small)

    rng = np.random.RandomState(0)
    for stats in (rng.normal(size=(N * budget, 1)).astype(np.float32),
                  rng.randint(0, 50, size=(N * budget, 1)).astype(np.int32)):
        want = jsharded.scatter_gathered_stats(
            jnp.asarray(stats), jorder, jvalid, mesh, "map", p_global=128)
        got = torch.cat([sharded.scatter_gathered_local(
            t_(stats), order, valid, r, N, 128) for r in range(N)])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tile_core_bodies_match_shard_map():
    mesh = jax_mesh("tile")
    args, binn, gt, jkw, port, tkw = core_setup(tile=(8, 8), chunk=16)
    fwd, bwd = jsharded.make_sharded_core(
        mesh, "tile", tile_xla.core_fwd_xla, tile_xla.core_bwd_xla,
        tile_batch=4, **jkw)
    a = fwd(*args, binn.tile_start, binn.tile_stop, gt)
    t = port["tile_start"].shape[0]
    assert t % N, "the grid should need padding"
    locs = [sharded.core_fwd_local(port["table"], port["tile_start"],
                                   port["tile_stop"], port["gt_tiles"], r, N,
                                   **tkw) for r in range(N)]
    got = render.CoreOutputs(
        *(torch.cat([getattr(x, f) for x in locs])[:t]
          for f in render.CoreOutputs._fields[:9]),
        sum(x.u_inst for x in locs), sum(x.npix_inst for x in locs))
    assert_core_close(a, got)
    one = render.core_fwd(**port, **tkw)
    for f in render.CoreOutputs._fields:
        assert torch.equal(getattr(got, f), getattr(one, f)), f

    cots = cotangents(*one.depth.shape)
    totals = (a.color, a.depth, a.weight, a.var, a.t_final)
    rows_j = bwd(*args[:5], binn.tile_start, binn.tile_stop, gt, *totals,
                 *(jnp.asarray(c) for c in cots))
    rows = sum(sharded.core_bwd_local(
        port["table"], port["tile_start"], port["tile_stop"],
        port["gt_tiles"], (x.color, x.depth, x.weight, x.var, x.t_final),
        tuple(torch.as_tensor(c) for c in cots), r, N, n_contrib=x.n_contrib,
        **tkw) for r, x in enumerate(locs))
    want = np.concatenate([np.asarray(x).reshape(rows.shape[0], -1)
                           for x in rows_j], 1)
    np.testing.assert_allclose(rows.numpy(), want, rtol=1e-3, atol=2e-4)
    one_rows = render.core_bwd(
        port["table"], port["tile_start"], port["tile_stop"],
        port["gt_tiles"], (one.color, one.depth, one.weight, one.var,
                           one.t_final),
        tuple(torch.as_tensor(c) for c in cots), n_contrib=one.n_contrib,
        **tkw)
    assert torch.equal(rows, one_rows)


def test_kf_bodies_match_shard_map():
    mesh = jmesh(shape=(N, 1), axis_names=("kf", "tile")) \
        if len(jax.devices()) >= N else jax_mesh("kf")
    scene, cam = make_scene(p=64, h=24, w=24, seed=5)
    kw = {k: v for k, v in scene.items()
          if k not in ("means3D", "gt_depth", "colors_precomp")}
    rng = np.random.RandomState(0)
    views = np.stack([np.asarray(cam.viewmatrix)] * N)
    rgbs = rng.uniform(0, 1, (N, 3, 24, 24)).astype(np.float32)
    depths = rng.uniform(1, 3, (N, 24, 24)).astype(np.float32)
    params = {"means3D": np.asarray(scene["means3D"]),
              "colors": np.asarray(scene["colors_precomp"])}

    def jax_loss(p, view, rgb, depth):
        cam2 = JaxCamera(viewmatrix=view, tanfovx=cam.tanfovx,
                         tanfovy=cam.tanfovy, height=24, width=24)
        out = jax_rasterize(p["means3D"], cam2, CFG, backend="xla",
                            tile_batch=4, gt_depth=depth,
                            colors_precomp=p["colors"], **kw)
        return jnp.mean((out.color - rgb) ** 2) + 0.3 * jnp.mean(
            (out.depth[0] - depth) ** 2)

    f = jsharded.sharded_value_and_grad(jax_loss, mesh, axis="kf")
    jl, jgrads = f({k: jnp.asarray(v) for k, v in params.items()},
                   jnp.asarray(views), jnp.asarray(rgbs), jnp.asarray(depths))

    tkw = to_torch(kw)
    tcam = port_camera(cam)
    cfg = port_config(CFG)

    def loss(p, view, rgb, depth):
        out = rasterize(p["means3D"], tcam.replace(viewmatrix=view), cfg,
                        gt_depth=depth, colors_precomp=p["colors"], **tkw)
        return ((out.color - rgb) ** 2).mean() + 0.3 * (
            (out.depth[0] - depth) ** 2).mean()

    tp = {k: t_(v) for k, v in params.items()}
    tv, tr, td = t_(views), t_(rgbs), t_(depths)
    parts = [sharded.kf_value_and_grad_local(loss, tp, tv, tr, td, (), r, N)
             for r in range(N)]
    total = sum(p[0] for p in parts) / N
    grads = {k: sum(p[1][k] for p in parts) / N for k in tp}
    one = sharded.kf_value_and_grad_local(loss, tp, tv, tr, td, (), 0, 1)
    np.testing.assert_allclose(float(total), float(one[0]) / N, rtol=1e-5)
    np.testing.assert_allclose(float(total), float(jl), rtol=1e-5)
    for k in tp:
        np.testing.assert_allclose(grads[k].numpy(),
                                   one[1][k].numpy() / N, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=5e-4, atol=2e-5, err_msg=k)


def test_pose_graph_bodies_match_shard_map():
    mesh = jax_mesh("kf")
    rng = np.random.RandomState(0)
    k = 7
    gt = [jnp.eye(4, dtype=jnp.float32)]
    for _ in range(1, k):
        gt.append(jlie.apply_twist(gt[-1], jnp.asarray(
            rng.uniform(-0.2, 0.2, 6), jnp.float32)))
    gt = jnp.stack(gt)
    edges = np.array([(i, i + 1) for i in range(k - 1)] + [(0, k - 1)],
                     np.int32)
    zs = jnp.stack([gt[j] @ jnp.linalg.inv(gt[i]) for i, j in edges])
    noisy = jnp.stack([gt[0]] + [jlie.apply_twist(gt[i], jnp.asarray(
        rng.uniform(-0.05, 0.05, 6), jnp.float32)) for i in range(1, k)])
    want = jsharded.refine_poses_sharded(noisy, edges, zs, mesh=mesh,
                                         iters=8)

    views = t_(noisy)
    shards = sharded.edge_shards(torch.as_tensor(edges, dtype=torch.int64),
                                 t_(zs), torch.ones(len(edges)), N)
    assert sum(int(w.sum() == 0) for _, _, w in shards) > 0, \
        "the edges should need padding"
    for _ in range(8):
        eqs = [sharded.normal_equations(views, *s) for s in shards]
        views = sharded.gn_update(views, sum(h for h, _ in eqs),
                                  sum(b for _, b in eqs), 1e6)
    np.testing.assert_allclose(views.numpy(), np.asarray(want), atol=1e-5)
    one = sharded.refine_poses_sharded(np.asarray(noisy), edges,
                                       np.asarray(zs), iters=8)
    np.testing.assert_allclose(views.numpy(), one.numpy(), atol=1e-5)
