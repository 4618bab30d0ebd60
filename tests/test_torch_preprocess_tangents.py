"""The preprocess's pose tangents (``ops/kernels/preprocess.py``) on the
CPU: :func:`preprocess_tangents_reference`, the closed form that the
``preprocess_tangents`` kernel computes and that
``rasterize.pose_jvp_tables`` runs on CPU tensors, against the
composite's forward mode (``torch.func.vmap`` of ``torch.func.jvp`` of
``ops/projection.py::preprocess``) in float64, column by column.

Every case has Gaussians past the field-of-view clamp, behind the near
plane, with colours clamped at 0, and one at the camera centre (a zero
view direction).  The cases cover the light variant, the 2D covariance
branch, the SH colour branch at degrees 1-3 with and without it,
``colors_precomp``, ``cov3D_precomp``, ``normalize_quaternions``, the
depth and NDC branches off, and K of 1, 6 and 7.
"""

import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu_torch.camera import Camera, look_at
from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.models import lie
from diff_gaussian_rasterization_tpu_torch.ops import projection
from diff_gaussian_rasterization_tpu_torch.ops import rasterize as ras
from diff_gaussian_rasterization_tpu_torch.ops.kernels import preprocess as kp
from diff_gaussian_rasterization_tpu_torch.ops.kernels.render import (
    tangent_columns)
from diff_gaussian_rasterization_tpu_torch.utils import profiling

torch.set_num_threads(2)

P, H, W = 160, 32, 40
F64 = torch.float64
FULL = dict(pose_cov2d_branch=True, pose_sh_branch=True)
CASES = {
    "light": dict(sh=1),
    "light_k1": dict(sh=1, k=1),
    "light_k7": dict(sh=1, k=7),
    "cov2d": dict(sh=1, cfg=dict(pose_cov2d_branch=True)),
    "cov2d_k7": dict(sh=0, k=7, cfg=dict(pose_cov2d_branch=True)),
    "sh1_colour": dict(sh=1, cfg=dict(pose_sh_branch=True)),
    "sh2_colour": dict(sh=2, cfg=dict(pose_sh_branch=True)),
    "sh3_colour": dict(sh=3, cfg=dict(pose_sh_branch=True)),
    "sh1_full": dict(sh=1, cfg=FULL),
    "sh2_full": dict(sh=2, cfg=FULL),
    "sh3_full": dict(sh=3, cfg=FULL),
    "sh3_full_k1": dict(sh=3, k=1, cfg=FULL),
    "sh3_full_k7": dict(sh=3, k=7, cfg=FULL),
    "sh0_full": dict(sh=0, cfg=FULL),
    "colors_precomp": dict(col=True, cfg=FULL),
    "cov3D_precomp": dict(sh=2, cov=True, cfg=FULL),
    "normalize_quaternions": dict(sh=1, cfg=dict(normalize_quaternions=True,
                                                 **FULL)),
    "depth_ndc_off": dict(sh=2, cfg=dict(pose_depth_branch=False,
                                         pose_ndc_branch=False, **FULL)),
}


def make_case(name, seed=0):
    """float64 inputs of a case: means, camera, config, the K view
    tangents (the twist basis at a small twist, then random directions
    past 6) and the preprocess keywords."""
    spec = CASES[name]
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.rand(*s, generator=g, dtype=F64)
    means = rnd(P, 3) * 2.0 - 1.0
    means[:, 2] = rnd(P) * 3.0 + 1.0
    means[:12, :2] *= 6.0                    # past the field-of-view clamp
    means[12:18, 2] = -rnd(6) - 0.5          # behind the near plane
    view = look_at((0.2, -0.1, -0.3), (0.1, 0.05, 3.0), dtype=F64,
                   device="cpu")
    cam = Camera(viewmatrix=view, tanfovx=float(np.tan(0.5)),
                 tanfovy=float(np.tan(0.4)), height=H, width=W)
    means[18] = cam.campos                   # a zero view direction
    quats = torch.randn(P, 4, generator=g, dtype=F64)
    kw = dict(opacities=rnd(P, 1), scales=rnd(P, 3) * 0.2 + 0.05,
              rotations=quats * (rnd(P, 1) * 0.6 + 0.7)
              / quats.norm(dim=1, keepdim=True))
    if spec.get("cov"):
        kw["cov3D_precomp"] = projection.compute_cov3d(
            kw.pop("scales"), kw.pop("rotations"), 1.0)
    if spec.get("col"):
        kw["colors_precomp"] = rnd(P, 3)
    else:
        deg = spec["sh"]
        shs = torch.randn(P, (deg + 1) ** 2 + 1, 3, generator=g,
                          dtype=F64) * 0.4
        shs[20:40, 0] = -6.0                 # colours clamped at 0
        shs[20:40, 1:] *= 0.1
        kw.update(shs=shs, sh_degree=deg)
    k_t = spec.get("k", 6)
    tw = torch.func.jacfwd(lambda x: lie.apply_twist(view, x))(
        torch.full((6,), 1e-3, dtype=F64)).movedim(-1, 0)
    if k_t < 6:
        tw = tw[:k_t]
    elif k_t > 6:
        tw = torch.cat([tw, torch.randn(k_t - 6, 4, 4, generator=g,
                                        dtype=F64) * 0.1])
    cfg = RasterConfig(tile_h=8, tile_w=8, **spec.get("cfg", {}))
    return means, cam, cfg, tw, kw


def composite_tangents(means, cam, cfg, tw, kw):
    """The composite's forward mode, the oracle the closed form is held
    to: [P, per_k * K]."""
    full = bool(cfg.pose_cov2d_branch)
    color = kp.color_branch(cfg, **kw)

    def feats(vm):
        pv = projection.preprocess(means, cam.replace(viewmatrix=vm), cfg,
                                   **kw)
        return (pv.xy, pv.depth) + ((pv.conic,) if full or color else ()) \
            + ((pv.color,) if color else ())

    t = torch.func.vmap(lambda d: torch.func.jvp(
        feats, (cam.viewmatrix,), (d,))[1])(tw)
    return torch.cat([t[0], t[1][..., None], *t[2:]], -1).movedim(
        0, 1).reshape(means.shape[0], -1)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_composite_forward_mode_float64(name):
    """The closed form gives the composite's tangents column for column,
    each within float64 rounding of its quantity's largest entry over the
    K tangents, in the layout of ``render.tangent_columns`` (zero conic
    columns where only the colour branch is on)."""
    means, cam, cfg, tw, kw = make_case(name)
    k_t = tw.shape[0]
    full = bool(cfg.pose_cov2d_branch)
    color = kp.color_branch(cfg, **kw)
    per_k = tangent_columns(full, color)
    want = composite_tangents(means, cam, cfg, tw, kw)
    got = kp.preprocess_tangents_reference(means, cam, cfg, tw, **kw)
    assert got.shape == want.shape == (P, per_k * k_t)
    assert bool(torch.isfinite(got).all())
    scale = want.abs().reshape(P, k_t, per_k).amax((0, 1))   # [per_k]
    err = (got - want).abs().reshape(P, k_t, per_k).amax(0)  # [K, per_k]
    assert bool((err <= 1e-10 * scale.clamp_min(1e-30)).all()), (
        err / scale.clamp_min(1e-30))
    cols = got.reshape(P, k_t, per_k)
    if cfg.pose_depth_branch:
        assert float(scale[2]) > 0
    else:
        assert not bool(cols[..., 2].any())
    if not cfg.pose_ndc_branch:
        assert not bool(cols[..., :2].any())
    if per_k > 3:
        assert bool(cols[..., 3:6].any()) == full
    if color:
        # the clamp at 0 stops the colour tangent, and it flows elsewhere
        assert not bool(cols[20:40, :, 6:].any())
        assert bool(cols[40:, :, 6:].any())


def test_wrapper_runs_the_reference_on_the_cpu():
    """On CPU tensors ``preprocess_tangents`` is its plain version and
    launches nothing."""
    means, cam, cfg, tw, kw = make_case("sh3_full")
    kp.reset_launches()
    got = kp.preprocess_tangents(means, cam, cfg, tw, **kw)
    assert torch.equal(got, kp.preprocess_tangents_reference(
        means, cam, cfg, tw, **kw))
    assert kp.launches["preprocess_tangents"] == 0


@pytest.mark.parametrize("variant", ["light", "full"])
def test_cpu_dual_render_gathers_the_reference_and_launches_no_kernel(
        variant):
    """``pose_jvp_tables`` on CPU tensors gathers the reference's tangents
    bit for bit, the composite's forward mode to float32 rounding; it
    launches no kernel, and with tracing on counts its Gaussians."""
    from diff_gaussian_rasterization_tpu_torch.scenes import small_scene
    means, skw, cam = small_scene(p=200, h=24, w=32, seed=5, sh_degree=1,
                                  device="cpu")
    cfg = RasterConfig(tile_h=8, tile_w=8)
    if variant == "full":
        cfg = cfg.full_variant()
    prep_kw = {k: skw[k] for k in ("scales", "rotations", "opacities", "shs",
                                   "sh_degree")}
    tw = torch.func.jacfwd(lambda x: lie.apply_twist(cam.viewmatrix, x))(
        torch.full((6,), 1e-3)).movedim(-1, 0)
    kp.reset_launches()
    profiling.reset()
    with torch.no_grad(), profiling.recording():
        _, binn, _, tans, _ = ras.pose_jvp_tables(
            means, cam, cfg, tw, None, skw["gt_depth"], **prep_kw)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    ref = kp.preprocess_tangents_reference(means, cam, cfg, tw,
                                           **prep_kw)[binn.gauss_id]
    assert torch.equal(tans, ref)
    want = composite_tangents(means, cam, cfg, tw, prep_kw)[binn.gauss_id]
    torch.testing.assert_close(tans, want, rtol=1e-4, atol=1e-4)
    assert counters["render.gaussians"] == 2 * means.shape[0]
    assert kp.launches["preprocess_tangents"] == 0
