"""The splat exponent's basis form (``RasterConfig.splat_basis_power``) in
the port, against the JAX package's Pallas path.

With the flag, the JAX package's Pallas kernels take the exponent as six
coefficients a splat about the tile's corner against the tile-local pixel
basis ``[1, x, y, x^2, y^2, x y]`` (``blend.splat_power`` with a basis);
its XLA backend keeps the direct form.  So the port is held here against
the Pallas kernels in interpret mode, as ``test_pallas_kernels.py`` runs
them: ``render_pallas.core_fwd`` / ``core_bwd`` on
``test_torch_render_fwd.setup()``'s aligned stream (8x16 tiles, chunk
128), ``rasterize(..., backend="pallas")`` (outputs and ``jax.grad``) and
``map_step``'s loss and gradients through that backend, each computed once
by a module fixture.  The tolerances are those of the port's direct-form
parity tests against the Pallas path for the same quantities: the render
core's outputs, and the images made of them, rtol 1e-4 / atol 2e-5
(``test_torch_render_fwd.py::test_reference_matches_pallas_interpret``;
the two packages sum the six-term power in other orders, which moves
alpha by up to ~1e-5 relative), gradient rows rtol 1e-3 / atol 2e-4
(``test_torch_render_bwd.py``), gradients rtol 1e-3 / atol 2e-4
(``test_torch_grad.py::test_gradient_parity_with_jax_pallas_interpret``);
integer outputs are equal.

Also held: the six coefficients of each splat about each tile's corner
bit for bit the JAX package's (what tells the basis form from the direct
one, whose images differ from it by rounding only); the port's basis
power within the culling box's rounding bound of the exact quadratic, and
close to the JAX package's; the plain cores
per rank at ``tile0 > 0`` bit-equal to the whole render; the meshed
renders, ``GaussianRasterizer`` and the SLAM runner's mapping with the
flag; the culling boxes never skipping a pair the blend keeps; the dual
render, ``track_frame`` and the runner's first tracked frame refusing the
flag with the JAX package's reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.models import slam as jslam
from diff_gaussian_rasterization_tpu.models.gaussians import (
    GaussianModel as JaxModel)
from diff_gaussian_rasterization_tpu.ops import blend as jblend
from diff_gaussian_rasterization_tpu.ops.kernels import render_pallas
from diff_gaussian_rasterization_tpu.ops.rasterize import (
    rasterize as jax_rasterize)
import diff_gaussian_rasterization_tpu_torch as dgr
from diff_gaussian_rasterization_tpu_torch.convert import (
    gaussian_model_from_numpy)
from diff_gaussian_rasterization_tpu_torch.io import synthetic
from diff_gaussian_rasterization_tpu_torch.models import runner, slam
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    PARAM_FIELDS, DensifyState)
from diff_gaussian_rasterization_tpu_torch.ops import blend
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
from diff_gaussian_rasterization_tpu_torch.ops.rasterize import (
    rasterize, rasterize_with_pose_jvp)
from diff_gaussian_rasterization_tpu_torch.parallel import sharded
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import make_mesh

from scenes import make_scene
from test_torch_grad import jax_grads, loss_terms, port_grads
from test_torch_mapping import (H, MCFG, TANX, TANY, W, jax_loss_grads,
                                small_model, window)
from test_torch_rasterize import port_camera, port_config, to_torch
from test_torch_render_bwd import cotangents
from test_torch_render_fwd import setup as core_setup
from torch_dist_cases import one_rank_world

torch.set_num_threads(2)

# the Pallas kernels take tiles of a multiple of 128 pixels
CFG = JaxConfig(tile_h=8, tile_w=16, chunk=128, splat_basis_power=True)
GRAD_KEYS = ("means3D", "scales", "rotations", "opacities", "colors_precomp")
REFUSAL = "pose-jvp requires the direct splat path"


def basis_setup(chunk=128):
    """``test_torch_render_fwd.setup()``'s stream with the flag on both
    sides."""
    args, binn, gt, jkw, port, tkw = core_setup(chunk=chunk)
    jkw = dict(jkw, cfg=jkw["cfg"].replace(splat_basis_power=True))
    tkw = dict(tkw, cfg=tkw["cfg"].replace(splat_basis_power=True))
    return args, binn, gt, jkw, port, tkw


def wc_of():
    return np.random.RandomState(1).uniform(0.5, 1, (3, 1, 1)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX Pallas result the tests hold the port to, computed once."""
    args, binn, gt, jkw, port, tkw = basis_setup()
    fwd = render_pallas.core_fwd(*args, binn.tile_start, binn.tile_stop, gt,
                                 interpret=True, **jkw)
    t, q = fwd.depth.shape
    cots = cotangents(t, q)
    totals = (fwd.color, fwd.depth, fwd.weight, fwd.var, fwd.t_final)
    bwd = render_pallas.core_bwd(*args[:5], binn.tile_start, binn.tile_stop,
                                 gt, *totals, *(jnp.asarray(c) for c in cots),
                                 interpret=True, **jkw)
    rows = np.concatenate([np.asarray(x).reshape(port["table"].shape[0], -1)
                           for x in bwd], axis=1)

    scene, cam = make_scene(p=48, h=24, w=32, seed=13)
    kw = {k: v for k, v in scene.items() if k != "means3D"}
    out = jax_rasterize(scene["means3D"], cam, CFG, backend="pallas",
                        tile_batch=4, **kw)
    wc = wc_of()
    grads = jax_grads(scene, cam, CFG, GRAD_KEYS,
                      lambda o: loss_terms(o, jnp.asarray(wc)),
                      backend="pallas")
    return dict(core=(args, binn, gt, jkw, port, tkw), fwd=fwd, cots=cots,
                rows=rows, scene=scene, cam=cam, out=out, grads=grads)


def assert_core_equal_ints(a, b, rtol=1e-4, atol=2e-5):
    """``test_torch_render_fwd.assert_core_close``'s float tolerances, and
    the integer fields equal."""
    for name in render.CoreOutputs._fields:
        x = np.asarray(getattr(a, name))
        y = getattr(b, name).cpu().numpy()
        assert x.shape == y.shape, name
        if x.dtype == np.int32:
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            np.testing.assert_allclose(y, x, rtol=rtol, atol=atol,
                                       err_msg=name)


# ---- the exponent --------------------------------------------------------


def random_splats(n=96, seed=0, origin=(48.0, 16.0), tile=(8, 16)):
    """Splats around one tile: centres from two tiles before to two after
    its corner, conics from thin to wide, some rotated near degeneracy."""
    rng = np.random.RandomState(seed)
    th, tw = tile
    xy = np.stack([origin[0] + rng.uniform(-2 * tw, 3 * tw, n),
                   origin[1] + rng.uniform(-2 * th, 3 * th, n)], 1)
    a = np.exp(rng.uniform(np.log(0.01), np.log(3.3), n))
    c = np.exp(rng.uniform(np.log(0.01), np.log(3.3), n))
    b = rng.uniform(-0.95, 0.95, n) * np.sqrt(a * c)
    op = rng.uniform(0.02, 0.99, n)
    f = lambda v: np.asarray(v, np.float32)
    return f(xy), f(np.stack([a, b, c], 1)), f(op)


def tile_pixels(origin, tile):
    th, tw = tile
    q = np.arange(th * tw)
    qx, qy = (q % tw).astype(np.float32), (q // tw).astype(np.float32)
    return qx, qy, qx + np.float32(origin[0]), qy + np.float32(origin[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_splat_power_basis_matches_jax_and_its_bound(seed):
    """The port's basis power (``blend.splat_power`` with a basis) against
    the JAX package's (an XLA ``dot``: another summation order) and the
    exact quadratic in float64: both within ``render.BASIS_REL`` times the
    sum of the magnitudes of the expansion's terms, the bound the culling
    box is widened by.  The direct form is unchanged."""
    origin, tile = (48.0, 16.0), (8, 16)
    xy, conic, _ = random_splats(seed=seed, origin=origin, tile=tile)
    qx, qy, px, py = tile_pixels(origin, tile)
    t = torch.as_tensor
    ox, oy = t(np.float32(origin[0])), t(np.float32(origin[1]))
    basis = blend.moment_basis(t(qx), t(qy), (0.0, 0.0))
    got = blend.splat_power(t(xy), t(conic), t(px), t(py), basis,
                            (ox, oy)).numpy()
    jbasis = jblend.moment_basis(jnp.asarray(qx), jnp.asarray(qy),
                                 origin=(0.0, 0.0))
    want = np.asarray(jblend.splat_power(
        jnp.asarray(xy), jnp.asarray(conic), jnp.asarray(px),
        jnp.asarray(py), basis=jbasis,
        origin=(jnp.float32(origin[0]), jnp.float32(origin[1]))))
    np.testing.assert_array_equal(basis.numpy(), np.asarray(jbasis))
    # exact, about the rounded xg = x - ox (what both forms expand)
    xg = (xy[:, 0] - np.float32(origin[0])).astype(np.float64)[:, None]
    yg = (xy[:, 1] - np.float32(origin[1])).astype(np.float64)[:, None]
    dx, dy = xg - qx[None].astype(np.float64), yg - qy[None].astype(
        np.float64)
    a, b, c = (conic[:, k].astype(np.float64)[:, None] for k in range(3))
    exact = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    big_x = np.abs(xg) + tile[1] - 1
    big_y = np.abs(yg) + tile[0] - 1
    s = 0.5 * np.abs(a) * big_x ** 2 + 0.5 * np.abs(c) * big_y ** 2 \
        + np.abs(b) * big_x * big_y
    bound = render.BASIS_REL * s
    assert np.all(np.abs(got - exact) <= bound)
    assert np.all(np.abs(want - exact) <= bound)
    assert np.all(np.abs(got - want) <= bound)
    # the two forms differ (by rounding only)
    direct = blend.splat_power(t(xy), t(conic), t(px), t(py)).numpy()
    assert np.any(direct != got)
    np.testing.assert_allclose(
        direct, np.asarray(jblend.splat_power(
            jnp.asarray(xy), jnp.asarray(conic), jnp.asarray(px),
            jnp.asarray(py))), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("tile0", [0, 5])
def test_splat_basis_coeffs_bit_equal_jax_per_tile(tile0):
    """The six coefficients the port expands each splat into, about each
    tile's corner as the render cores take it (``render.splat_basis`` on
    ``pixel_coords`` at ``tile0``), bit for bit the JAX package's about the
    Pallas kernels' origin ``(tx tile_w, ty tile_h)``.  JAX's coefficients
    are read through its ``splat_power`` with the identity as the basis
    (each column of the ``dot`` is one coefficient times 1 plus zeros,
    exact).  The power, a sum of the six terms in another order on each
    side, is compared at its rounding bound above."""
    th, tw, tiles_x, n_tiles = 8, 16, 4, 3
    cfg = port_config(CFG)
    px, py, _ = render.pixel_coords(n_tiles, tiles_x, th, tw, 64, 64, "cpu",
                                    tile0=tile0)
    origin = render.splat_basis(cfg, px, py)["origin"]
    eye = jnp.eye(6, dtype=jnp.float32)
    for i in range(n_tiles):
        tg = tile0 + i
        jorigin = (np.float32(tg % tiles_x * tw), np.float32(tg // tiles_x
                                                              * th))
        assert (float(origin[0][i]), float(origin[1][i])) == jorigin
        xy, conic, _ = random_splats(n=64, seed=tg, origin=jorigin,
                                     tile=(th, tw))
        got = torch.cat(blend.splat_basis_coeffs(
            torch.as_tensor(xy), torch.as_tensor(conic),
            (origin[0][i], origin[1][i])), dim=-1).numpy()
        want = np.asarray(jblend.splat_power(
            jnp.asarray(xy), jnp.asarray(conic), None, None, basis=eye,
            origin=tuple(jnp.float32(o) for o in jorigin)))
        assert got.shape == want.shape == (64, 6)
        np.testing.assert_array_equal(got, want)
        assert np.all(got[:, 0] != 0) and np.all(got[:, 3] < 0)


def test_splat_alpha_basis_is_the_kernels_expression():
    """``splat_alpha`` with a basis is ``min(cap, op * exp(power))`` of
    the basis power, and the chunk weights follow it."""
    origin, tile = (0.0, 8.0), (8, 16)
    xy, conic, op = random_splats(n=32, seed=2, origin=origin, tile=tile)
    qx, qy, px, py = tile_pixels(origin, tile)
    t = torch.as_tensor
    kw = dict(basis=blend.moment_basis(t(qx), t(qy), (0.0, 0.0)),
              origin=(t(np.float32(origin[0])), t(np.float32(origin[1]))))
    cfg = port_config(CFG)
    alpha, ok = blend.splat_alpha(t(xy), t(conic), t(op), t(px), t(py), cfg,
                                  **kw)
    power = blend.splat_power(t(xy), t(conic), t(px), t(py), **kw)
    assert torch.equal(alpha, torch.clamp_max(t(op)[:, None]
                                              * torch.exp(power), 0.99))
    assert torch.equal(ok, (power <= 0) & (alpha >= cfg.alpha_min))
    assert bool(ok.any()) and not bool(ok.all())


# ---- the render cores ----------------------------------------------------


def test_core_fwd_reference_matches_pallas_basis(jax_side):
    _, _, _, _, port, tkw = jax_side["core"]
    got = render.core_fwd(**port, **tkw)        # CPU: the plain version
    assert_core_equal_ints(jax_side["fwd"], got)
    assert int((got.n_valid > 0).sum()) > 0 and int((got.midx >= 0).sum()) > 0
    # the flag moves the floats, by rounding
    direct = render.core_fwd(**port, **dict(tkw, cfg=tkw["cfg"].replace(
        splat_basis_power=False)))
    assert not torch.equal(direct.color, got.color)
    np.testing.assert_allclose(direct.color.numpy(), got.color.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("want", [(True, True), (False, False)])
def test_core_bwd_reference_matches_pallas_basis(jax_side, want):
    """The plain backward's rows against the Pallas ``_bwd_kernel``'s
    (computed with median and variance streams; the case without them
    holds the other columns and leaves those two zero)."""
    _, _, _, _, port, tkw = jax_side["core"]
    fwd = jax_side["fwd"]
    totals = tuple(torch.as_tensor(np.array(x)) for x in
                   (fwd.color, fwd.depth, fwd.weight, fwd.var, fwd.t_final))
    rows = render.core_bwd(
        port["table"], port["tile_start"], port["tile_stop"],
        port["gt_tiles"], totals,
        tuple(torch.as_tensor(c) for c in jax_side["cots"]),
        want_med=want[0], want_var=want[1],
        n_contrib=torch.as_tensor(np.array(fwd.n_contrib)), **tkw).numpy()
    ref = jax_side["rows"]
    cols = range(render.ROW) if want[0] else range(10)
    for c in cols:
        np.testing.assert_allclose(rows[:, c], ref[:, c], rtol=1e-3,
                                   atol=2e-4, err_msg=render.ROW_COLUMNS[c])
    if not want[0]:
        assert float(np.abs(rows[:, 10:]).max()) == 0.0
    assert float(np.abs(rows[:, 5]).max()) > 0


@pytest.mark.parametrize("n", [2, 3])
def test_tile_sharded_bodies_bit_equal_basis(jax_side, n):
    """The plain cores on each rank's run of tiles (``tile0 > 0`` for all
    but the first) put together are the whole render bit for bit: the
    basis is taken about the image tile's corner, whatever the launch's
    first tile."""
    _, _, _, _, port, tkw = jax_side["core"]
    one = render.core_fwd(**port, **tkw)
    t = port["tile_start"].shape[0]
    locs = [sharded.core_fwd_local(port["table"], port["tile_start"],
                                   port["tile_stop"], port["gt_tiles"], r, n,
                                   **tkw) for r in range(n)]
    assert sharded.tile_share(t, n, n - 1)[0] > 0
    got = render.CoreOutputs(
        *(torch.cat([getattr(x, f) for x in locs])[:t]
          for f in render.CoreOutputs._fields[:9]),
        sum(x.u_inst for x in locs), sum(x.npix_inst for x in locs))
    for f in render.CoreOutputs._fields:
        assert torch.equal(getattr(got, f), getattr(one, f)), f
    cots = tuple(torch.as_tensor(c) for c in cotangents(*one.depth.shape))
    rows = sum(sharded.core_bwd_local(
        port["table"], port["tile_start"], port["tile_stop"],
        port["gt_tiles"], (x.color, x.depth, x.weight, x.var, x.t_final),
        cots, r, n, n_contrib=x.n_contrib, **tkw) for r, x in enumerate(locs))
    one_rows = render.core_bwd(
        port["table"], port["tile_start"], port["tile_stop"],
        port["gt_tiles"], (one.color, one.depth, one.weight, one.var,
                           one.t_final), cots, n_contrib=one.n_contrib,
        **tkw)
    assert torch.equal(rows, one_rows)


def test_cull_extent_holds_for_the_basis_form(jax_side):
    """``render.cull_misses``: no pair of the binning lies outside the
    culling box of its tile (the basis form's, widened for its rounding)
    while the blend would keep it, on the test scene and on splats placed
    from two tiles before to two after a tile, thin, wide and rotated; the
    direct form's boxes on the same pairs too.  The basis box is the
    direct one grown, never shrunk."""
    _, _, _, _, port, tkw = jax_side["core"]
    cfg = tkw["cfg"]
    geo = dict(tiles_x=tkw["tiles_x"], height=tkw["height"],
               width=tkw["width"])
    assert render.cull_misses(port["table"], port["tile_start"],
                              port["tile_stop"], cfg=cfg, **geo) == 0
    # a stress table: every splat in the segment of the last tile of a
    # 4 x 3 grid of 8x16 tiles, whose corner is (48, 16)
    n, origin, tile = 4000, (48.0, 16.0), (8, 16)
    xy, conic, op = random_splats(n=n, seed=3, origin=origin, tile=tile)
    table = torch.zeros((n, render.FEAT))
    table[:, 0:2], table[:, 2:5] = torch.as_tensor(xy), torch.as_tensor(conic)
    table[:, 5] = torch.as_tensor(op)
    start = torch.zeros(12, dtype=torch.int32)
    stop = torch.zeros(12, dtype=torch.int32)
    stop[11] = n
    stress = dict(tiles_x=4, height=24, width=64)
    for flag in (True, False):
        assert render.cull_misses(table, start, stop,
                                  cfg=cfg.replace(splat_basis_power=flag),
                                  **stress) == 0
    ox = torch.full((n,), origin[0])
    oy = torch.full((n,), origin[1])
    rb = render.cull_extent(table[:, 2:5], table[:, 5], cfg.alpha_min,
                            table[:, 0:2], (ox, oy), tile)
    rd = render.cull_extent(table[:, 2:5], table[:, 5], cfg.alpha_min)
    assert bool((rb[0] >= rd[0]).all() and (rb[1] >= rd[1]).all())


# ---- the render op and its callers ---------------------------------------


def test_rasterize_basis_matches_jax_pallas(jax_side):
    """Outputs of the port's ``rasterize`` with the flag against the JAX
    ``rasterize(backend="pallas")``."""
    scene, cam, a = jax_side["scene"], jax_side["cam"], jax_side["out"]
    kw = to_torch({k: v for k, v in scene.items() if k != "means3D"})
    b = rasterize(torch.as_tensor(np.array(scene["means3D"])),
                  port_camera(cam), port_config(CFG), **kw)
    n = lambda x: x.detach().numpy()
    for f in ("color", "depth", "opacity_map", "depth_median"):
        np.testing.assert_allclose(n(getattr(b, f)), np.asarray(getattr(a, f)),
                                   rtol=1e-4, atol=2e-5, err_msg=f)
    np.testing.assert_allclose(n(b.gau_uncertainty),
                               np.asarray(a.gau_uncertainty), rtol=1e-4,
                               atol=1e-5)
    for f in ("n_contrib", "n_valid", "gau_related_pixels", "radii",
              "num_rendered", "overflow"):
        np.testing.assert_array_equal(n(getattr(b, f)),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert float(b.opacity_map.max()) > 0.5


def test_rasterize_basis_gradients_match_jax_pallas(jax_side):
    """Gradients of every output's loss w.r.t. the means, scales,
    rotations, opacities, colors and the view matrix, against ``jax.grad``
    through the JAX Pallas path (``_bwd_kernel`` with the basis)."""
    wc = wc_of()
    got = port_grads(jax_side["scene"], jax_side["cam"], CFG, GRAD_KEYS,
                     lambda o: loss_terms(o, torch.as_tensor(wc), torch))
    want = jax_side["grads"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=2e-4,
                                   err_msg=k)
        assert float(np.abs(got[k]).max()) > 0, k


def test_api_basis_bit_equal_to_rasterize():
    """``GaussianRasterizer`` with the flag in its ``config`` launches what
    ``rasterize`` does: outputs and gradients bit for bit."""
    scene, cam = make_scene(p=48, h=24, w=32, seed=13)
    s = {k: np.asarray(v) for k, v in scene.items()}
    t = lambda x: torch.tensor(x, dtype=torch.float32, requires_grad=True)
    leaves = {k: t(s[k]) for k in GRAD_KEYS}
    view = torch.as_tensor(np.array(cam.viewmatrix))
    settings = dgr.GaussianRasterizationSettings(
        image_height=24, image_width=32, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=torch.as_tensor(s["bg"]), scale_modifier=1.0,
        viewmatrix=view)
    cfg = port_config(CFG)
    out = dgr.GaussianRasterizer(settings, config=cfg)(
        gt_depth=torch.as_tensor(s["gt_depth"]), **leaves)
    (out[0].sum() + 0.3 * out[2].sum()).backward()
    ref_leaves = {k: t(s[k]) for k in GRAD_KEYS}
    means = ref_leaves.pop("means3D")
    ref = rasterize(means, port_camera(cam), cfg, bg=torch.as_tensor(s["bg"]),
                    gt_depth=torch.as_tensor(s["gt_depth"]), **ref_leaves)
    (ref.color.sum() + 0.3 * ref.depth.sum()).backward()
    ref_leaves["means3D"] = means
    assert torch.equal(out[0], ref.color) and torch.equal(out[2], ref.depth)
    for k in GRAD_KEYS:
        assert torch.equal(leaves[k].grad, ref_leaves[k].grad), k
    # and the flag reaches the kernels' plain versions: the direct form
    # renders other bits
    direct = rasterize(means.detach(), port_camera(cam),
                       cfg.replace(splat_basis_power=False),
                       bg=torch.as_tensor(s["bg"]),
                       gt_depth=torch.as_tensor(s["gt_depth"]),
                       **{k: v.detach() for k, v in ref_leaves.items()
                          if k != "means3D"})
    assert not torch.equal(direct.color, ref.color)


def test_meshed_rasterize_basis_one_rank():
    """Tile-sharded and shard-binned ``rasterize`` with the flag on a
    one-rank gloo mesh: the unsharded render's outputs and gradients bit
    for bit (the flag travels through the tile core and the band core)."""
    scene, cam = make_scene(p=48, h=24, w=32, seed=13)
    cfg = port_config(CFG)

    def run(**mesh_kw):
        kw = to_torch({k: v for k, v in scene.items() if k != "means3D"})
        means = torch.as_tensor(np.array(scene["means3D"])).requires_grad_()
        out = rasterize(means, port_camera(cam), cfg, **kw, **mesh_kw)
        (out.color.sum() + out.depth.sum()).backward()
        return out, means.grad

    base, g = run()
    with one_rank_world():
        mesh = make_mesh((1,), ("tile",), backend="gloo")
        for sb in (False, True):
            out, gm = run(mesh=mesh, shard_binning=sb)
            assert torch.equal(out.color, base.color), sb
            assert torch.equal(out.n_contrib, base.n_contrib), sb
            assert torch.equal(gm, g), sb


@pytest.fixture(scope="module")
def jax_map():
    cfg = CFG.replace(instance_multiplier=12, backend="pallas")
    fields = small_model()
    views, rgbs, depths, wts = window()
    mcfg = jslam.MappingConfig(**MCFG)
    loss, grads = jax_loss_grads(fields, views, rgbs, depths, wts, cfg, mcfg)
    return cfg, mcfg, fields, (views, rgbs, depths, wts), float(loss), grads


def test_map_step_basis_matches_jax(jax_map):
    """One ``map_step`` with the flag over ``test_torch_mapping.py``'s
    two-keyframe window: its loss and gradients against the JAX package's
    through the Pallas backend."""
    cfg, mcfg_j, fields, (views, rgbs, depths, wts), jl, jg = jax_map
    mcfg = slam.MappingConfig(**{f.name: getattr(mcfg_j, f.name)
                                 for f in dataclasses.fields(
                                     slam.MappingConfig)})
    tm = gaussian_model_from_numpy(fields, device="cpu")
    opt = slam.make_map_optimizer(tm, mcfg)
    td = DensifyState.zero(tm.means3D.shape[0], device="cpu")
    t = torch.as_tensor
    loss, _, _ = slam.map_step(tm, opt, td, t(views), t(rgbs), t(depths),
                               t(wts), port_config(cfg), mcfg, H, W, TANX,
                               TANY, 2)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(),
                                   np.asarray(jg[k]), rtol=1e-3, atol=2e-4,
                                   err_msg=k)
        assert float(np.abs(np.asarray(jg[k])).max()) > 0, k


# ---- the refusals --------------------------------------------------------


def test_pose_jvp_refuses_basis():
    """The dual render differentiates the direct exponent: the port's
    ``rasterize_with_pose_jvp`` and ``core_fwd_jvp`` raise ``ValueError``
    with the reason the JAX package asserts."""
    scene, cam = make_scene(p=32, h=16, w=32, seed=5)
    kw = to_torch({k: v for k, v in scene.items()
                   if k not in ("means3D", "bg", "gt_depth")})
    tcam = port_camera(cam)
    tans = torch.zeros((6, 4, 4))
    with pytest.raises(ValueError, match=REFUSAL):
        rasterize_with_pose_jvp(
            torch.as_tensor(np.array(scene["means3D"])), tcam,
            port_config(CFG), tans, **kw)
    table = torch.zeros((4, render.FEAT))
    ranges = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=REFUSAL):
        render.core_fwd_jvp(table, torch.zeros((4, 3)), ranges, ranges,
                            torch.zeros((2, 128)), cfg=port_config(CFG),
                            tiles_x=2, height=8, width=32)


def test_track_frame_refuses_basis_as_jax():
    """``track_frame`` (Gauss-Newton through the dual render) with the
    flag: the JAX package's assertion and the port's ``ValueError`` carry
    one reason."""
    fields = small_model()
    views, rgbs, depths, _ = window()
    cam = JaxCamera(viewmatrix=jnp.asarray(views[0]), tanfovx=TANX,
                    tanfovy=TANY, height=H, width=rgbs.shape[-1])
    jm = JaxModel(**{k: jnp.asarray(v) for k, v in fields.items()})
    with pytest.raises(AssertionError, match=REFUSAL):
        jslam.track_frame(jm, jnp.asarray(views[1]),
                          jslam.Frame(jnp.asarray(rgbs[1]),
                                      jnp.asarray(depths[1])), CFG,
                          jslam.TrackingConfig(iters=1), cam)
    tm = gaussian_model_from_numpy(fields, device="cpu")
    t = torch.as_tensor
    with pytest.raises(ValueError, match=REFUSAL):
        slam.track_frame(tm, t(views[1]), slam.Frame(t(rgbs[1]), t(depths[1])),
                         port_config(CFG), slam.TrackingConfig(iters=1),
                         port_camera(cam))


def test_slam_with_basis_maps_then_refuses_the_first_tracked_frame():
    """A ``SLAMConfig.raster`` with the flag: ``init_slam`` maps the first
    frame with it, and the first tracked frame refuses it, as the JAX
    package's runner does."""
    from test_torch_runner import CFG as RCFG, cams
    _, ct = cams()
    gt = synthetic.random_room_model(capacity=256, n=256, seed=3,
                                     device="cpu")
    views = synthetic.orbit_trajectory(2, device="cpu")
    frames = synthetic.render_sequence(gt, views, ct, RCFG)
    scfg = runner.SLAMConfig(
        raster=RCFG.replace(splat_basis_power=True),
        tracking=slam.TrackingConfig(iters=2, sil_threshold=0.5),
        mapping=slam.MappingConfig(iters=2), capacity=1024, window=2,
        seed_every_px=4, init_iters=2, motion_model=False)
    state = runner.init_slam(views[0], frames[0], ct, scfg)
    assert int(state.model.num_active) > 0
    assert all(bool(torch.isfinite(getattr(state.model, f)).all())
               for f in PARAM_FIELDS)
    with pytest.raises(ValueError, match=REFUSAL):
        runner.slam_step(state, frames[1], ct, scfg, 1)
