"""The dual render's SH colour branch on the CPU, against the plain
reference of the Full variant (``splatbench/reference_full.py``: autodiff
of a plain forward with nothing detached).

On seeded random Gaussians (300 of them, 40x56, 8x8 tiles) in float32:

- ``rasterize_with_pose_jvp``'s image and six twist tangents against
  ``reference_full.dual_render`` over SH degree 0, 1 and 3 and the light,
  Σ2D-only and full variants;
- ``track_frame`` against ``reference_full.track`` at SH 3, full variant;
- forward against reverse: each tangent image contracted with a fixed
  cotangent equals the port's own ``rasterize`` backward pose gradient
  along that direction;
- the light and Σ2D-only tangent tables, and the full variant's at SH 0,
  which takes no colour columns, in the layout before the colour columns
  (a copy of that code below): bit-equal to the closed form
  ``preprocess_tangents_reference`` and within float32 rounding of the
  composite's forward mode;
- the counters a traced dual render records.

Tolerances.  Both sides are float32 sums of a few hundred terms a pixel,
so each departs from the exact value by ~1e-7 of the stream's largest
entry; measured, the two sides agree to 6e-7 of it.  ``REL`` = 1e-5 of
the stream's largest entry leaves 16x room.  Dropping the colour branch
moves the colour tangents by ~15% of their largest entry at SH 3 (and
~3% at SH 1), which the tests assert fails ``REL``.  The tracked pose
agrees to ~1e-7 (a view-matrix entry); ``POSE_TOL`` = 1e-5 leaves 100x,
and the tracker without the colour branch lands 2e-3 away.
"""

import pytest
import torch

from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.models import lie, slam
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    GaussianModel)
from diff_gaussian_rasterization_tpu_torch.ops import projection
from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
from diff_gaussian_rasterization_tpu_torch.ops.kernels import preprocess as kp
from diff_gaussian_rasterization_tpu_torch.ops.kernels import render
from diff_gaussian_rasterization_tpu_torch.scenes import small_scene
from diff_gaussian_rasterization_tpu_torch.utils import profiling
from splatbench import reference as ref
from splatbench import reference_full as rf
from splatbench.entry import tcfg_dict

torch.set_num_threads(2)

P, H, W, TILE = 300, 40, 56, 8
REL = 1e-5        # of a stream's largest entry (the module docstring)
POSE_TOL = 1e-5   # largest view-matrix entry gap
GT = torch.zeros(H, W)   # the ground-truth depth the tables' callers pass
VARIANTS = {"light": (False, False), "sigma2d": (True, False),
            "full": (True, True)}


def scene(deg, seed=3):
    means, kw, cam = small_scene(p=P, h=H, w=W, seed=seed, sh_degree=deg,
                                 device="cpu")
    prep_kw = {k: kw[k] for k in ("opacities", "scales", "rotations", "shs",
                                  "sh_degree")}
    return means, prep_kw, cam


def config(variant):
    cov, sh = VARIANTS[variant]
    return RasterConfig(tile_h=TILE, tile_w=TILE, pose_cov2d_branch=cov,
                        pose_sh_branch=sh)


def twist_basis(view):
    return torch.func.jacfwd(lambda x: lie.apply_twist(view, x))(
        torch.zeros(6, dtype=view.dtype)).movedim(-1, 0)


def flat(xs):
    return torch.cat([x.reshape(-1) for x in xs])


def port_dual(means, prep_kw, cam, cfg):
    """The port's dual render flattened as ``reference.dual_render``'s:
    ``(primal [n], tangents [6, n])``."""
    j = ras.rasterize_with_pose_jvp(means, cam, cfg,
                                    twist_basis(cam.viewmatrix), **prep_kw)
    return (flat([j.out.color, j.out.depth, j.out.opacity_map]),
            torch.stack([flat([j.color[k], j.depth[k], j.opacity_map[k]])
                         for k in range(6)]))


def ref_dual(means, prep_kw, cam, variant):
    cov, sh = VARIANTS[variant]
    f = (means, prep_kw["scales"], prep_kw["rotations"],
         prep_kw["opacities"].reshape(-1), prep_kw["shs"])
    return rf.dual_render(f, cam.viewmatrix,
                          ref.Cam(H, W, cam.tanfovx, cam.tanfovy),
                          ref.Raster(tile_h=TILE, tile_w=TILE),
                          cov_branch=cov, sh_branch=sh)


def stream_errors(got, want):
    """Each stream's (colour, depth, silhouette) largest error over its
    largest entry, over the six tangents."""
    sizes = [3 * H * W, H * W, H * W]
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(torch.split(got, sizes, -1),
                            torch.split(want, sizes, -1))]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("deg", [0, 1, 3])
def test_dual_render_matches_reference_full(deg, variant):
    means, prep_kw, cam = scene(deg)
    prim, tans = port_dual(means, prep_kw, cam, config(variant))
    want_p, want_t = ref_dual(means, prep_kw, cam, variant)
    assert max(stream_errors(prim, want_p)) < REL
    errs = stream_errors(tans, want_t)
    assert max(errs) < REL, errs


@pytest.mark.parametrize("deg", [1, 3])
def test_dropping_the_colour_branch_fails(deg):
    """The parent's dual render (no colour tangents) against the full
    reference: its colour tangents miss by far more than ``REL``."""
    means, prep_kw, cam = scene(deg)
    _, tans = port_dual(means, prep_kw, cam, config("sigma2d"))
    _, want = ref_dual(means, prep_kw, cam, "full")
    assert stream_errors(tans, want)[0] > 100 * REL


def model_of(means, prep_kw):
    op = prep_kw["opacities"]
    return GaussianModel(means, torch.log(prep_kw["scales"]),
                         prep_kw["rotations"], torch.log(op / (1 - op)),
                         prep_kw["shs"], torch.ones(P, dtype=torch.bool))


def test_track_frame_matches_reference_full():
    """``track_frame`` at SH 3 with the full variant from a perturbed start
    pose, Gauss-Newton with frozen binning, two levels: the pose the
    reference's tracker reaches, within ``POSE_TOL``; without the colour
    branch the port lands far outside it."""
    means, prep_kw, cam = scene(3)
    model = model_of(means, prep_kw)
    cfg = config("full")
    with torch.no_grad():
        out = ras.rasterize(means, cam, cfg, **model.raster_kwargs())
    frame = slam.Frame(out.color, out.depth[0])
    view0 = lie.apply_twist(cam.viewmatrix, torch.tensor(
        [0.01, -0.008, 0.006, 0.004, -0.003, 0.005]))
    t = dict(method="gn", iters=2, pyramid=2, coarse_iters=2,
             freeze_binning=True, bin_margin_px=2.0, line_search=False)
    want = rf.track(rf.gaussian_fields(
        means, model.scales_log, model.rotations, model.opacities_logit,
        model.sh, model.active), view0, frame.rgb, frame.depth,
        ref.Cam(H, W, cam.tanfovx, cam.tanfovy),
        ref.Raster(tile_h=TILE, tile_w=TILE), tcfg_dict(t))
    tcfg = slam.TrackingConfig(**t)
    got, _, _ = slam.track_frame(model, view0, frame, cfg, tcfg, cam)
    assert float((got - want).abs().max()) < POSE_TOL
    lame, _, _ = slam.track_frame(model, view0, frame,
                                  cfg.replace(pose_sh_branch=False), tcfg,
                                  cam)
    assert float((lame - want).abs().max()) > 10 * POSE_TOL


@pytest.mark.parametrize("deg", [1, 3])
def test_forward_tangents_equal_the_reverse_pose_gradient(deg):
    """<cotangent, tangent image k> equals <d loss / d view, direction k>,
    the loss the cotangent's inner product with ``rasterize``'s images and
    its view gradient the preprocess's closed-form backward."""
    means, prep_kw, cam = scene(deg)
    cfg = config("full")
    g = torch.Generator().manual_seed(5)
    cots = [torch.randn(s, generator=g) for s in ((3, H, W), (1, H, W),
                                                  (1, H, W))]
    view = cam.viewmatrix.clone().requires_grad_(True)
    out = ras.rasterize(means, cam.replace(viewmatrix=view), cfg, **prep_kw)
    loss = sum((c * x).sum() for c, x in zip(cots, (
        out.color, out.depth, out.opacity_map)))
    (gview,) = torch.autograd.grad(loss, view)
    tw = twist_basis(cam.viewmatrix)
    j = ras.rasterize_with_pose_jvp(means, cam, cfg, tw, **prep_kw)
    fwd = torch.stack([sum((c * x[k]).sum() for c, x in zip(
        cots, (j.color, j.depth[:, None], j.opacity_map[:, None])))
        for k in range(6)])
    rev = (gview[None] * tw).sum((1, 2))
    # float32 sums over the image: 1e-5 of the largest directional value
    torch.testing.assert_close(fwd, rev, rtol=0,
                               atol=1e-5 * float(rev.abs().max()))


def parent_tangent_table(means, cam, cfg, tw, binn, prep_kw):
    """The tangent table as it was laid out before the colour columns: per
    direction dx, dy, ddepth and, with ``pose_cov2d_branch``, dA, dB, dC
    (a copy of that code)."""
    full = bool(cfg.pose_cov2d_branch)

    def feats(vm):
        pv = projection.preprocess(means, cam.replace(viewmatrix=vm), cfg,
                                   **prep_kw)
        return (pv.xy, pv.depth) + ((pv.conic,) if full else ())

    t = torch.func.vmap(lambda d: torch.func.jvp(
        feats, (cam.viewmatrix,), (d,))[1])(tw)
    tab = torch.cat([t[0], t[1][..., None], *t[2:]], -1).movedim(0, 1)
    return tab.reshape(means.shape[0], -1)[binn.gauss_id]


@pytest.mark.parametrize("variant,deg", [
    ("light", 0), ("light", 1), ("light", 3), ("sigma2d", 0),
    ("sigma2d", 1), ("sigma2d", 3), ("full", 0)])
def test_tangent_tables_without_colour_keep_their_layout(variant, deg):
    means, prep_kw, cam = scene(deg)
    cfg = config(variant)
    tw = twist_basis(cam.viewmatrix)
    with torch.no_grad():
        _, binn, _, tans, _ = ras.pose_jvp_tables(means, cam, cfg, tw, None,
                                                  GT, **prep_kw)
        want = parent_tangent_table(means, cam, cfg, tw, binn, prep_kw)
        ref = kp.preprocess_tangents_reference(means, cam, cfg, tw,
                                               **prep_kw)[binn.gauss_id]
    assert tans.shape[1] == 6 * (3 if variant == "light" else 6)
    assert torch.equal(tans, ref)
    torch.testing.assert_close(tans, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cov", [True, False])
def test_colour_columns_follow_the_conic(cov):
    """With the colour branch a tangent has 9 columns: dx, dy, ddepth, the
    conic's three (zeros without ``pose_cov2d_branch``), then the colour's
    three, the closed form's bit for bit and the composite's forward-mode
    colour tangents to float32 rounding."""
    means, prep_kw, cam = scene(3)
    cfg = RasterConfig(tile_h=TILE, tile_w=TILE, pose_cov2d_branch=cov,
                       pose_sh_branch=True)
    tw = twist_basis(cam.viewmatrix)
    with torch.no_grad():
        _, binn, _, tans, _ = ras.pose_jvp_tables(means, cam, cfg, tw, None,
                                                  GT, **prep_kw)
        _, dcolor = torch.func.vmap(lambda d: torch.func.jvp(
            lambda vm: projection.preprocess(
                means, cam.replace(viewmatrix=vm), cfg, **prep_kw).color,
            (cam.viewmatrix,), (d,)))(tw)
        ref = kp.preprocess_tangents_reference(means, cam, cfg, tw,
                                               **prep_kw)[binn.gauss_id]
    by_k = tans.reshape(tans.shape[0], 6, 9)
    assert render.tangent_columns(cov, True) == 9
    assert torch.equal(tans, ref)
    torch.testing.assert_close(by_k[..., 6:9],
                               dcolor.movedim(0, 1)[binn.gauss_id],
                               rtol=1e-4, atol=1e-4)
    assert bool(by_k[..., 3:6].any()) == cov
    assert float(by_k[..., 6:9].abs().max()) > 0


def test_dual_render_counts_colour_tangents_and_table_floats():
    means, prep_kw, cam = scene(3)
    tw = twist_basis(cam.viewmatrix)
    for variant, per_k, colour in (("full", 9, P * 6), ("sigma2d", 6, None),
                                   ("light", 3, None)):
        profiling.reset()
        with torch.no_grad(), profiling.recording():
            _, binn, _, _, _ = ras.pose_jvp_tables(
                means, cam, config(variant), tw, None, GT, **prep_kw)
        c = profiling.snapshot()["counters"]
        assert c.get("render.color_tangents") == colour
        assert c["render.tangent_floats"] == \
            binn.gauss_id.shape[0] * per_k * 6
    profiling.reset()
