"""Tracking's Gauss-Newton kernels (``ops/kernels/gauss_newton.py``) on the
card, against their plain versions.

Every test here needs a CUDA device and skips without one; the file
imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_gauss_newton.py

- ``twist_tangents`` against ``torch.func.jacfwd`` of ``lie.apply_twist``
  in float64 at the same float32 inputs, at xi = 0, inside the Taylor
  branch (|w|^2 ~ 1e-13), at |w| = 1e-3 and at 0.5 rad: within 4 float32
  ulps of the largest entry (the kernel computes in double and rounds
  once).
- ``gn_reduce``, full and cost only, against ``gn_reduce_reference`` at
  1200 x 680 and 320 x 240: rtol 1e-5 with an atol of 1e-5 of the
  quantity's largest entry (the plain version sums in float32, the kernel
  in double; an entry of H may cancel); two calls bit-identical.
- The LM stage against ``lm_update_reference`` for an accepted, a
  rejected and a non-finite step, in the deferred and the line-search
  modes.
- ``track_frame`` with the kernels against the plain path (the wrappers
  replaced by their plain versions, on the card), with the Replica cells'
  configuration (deferred accept, frozen binning) and the TUM cells'
  (line search, fresh binning): views within 1e-6; the reported cost
  equal to the plain reduction's of a fresh render at the reported view
  (rtol 1e-5); the per-iteration costs at rtol 5e-3, since the tracking
  mask (silhouette above its threshold) is discontinuous in the pose: one
  pixel at an occlusion edge crossing it moves a converged frame's cost
  by ~5e-4 of ~0.24, and views 2e-8 apart read costs 2.2e-3 apart (the
  plain float32 solve's trajectory); no ``torch.func`` call; the kernels'
  launches a tracked frame, at most 4 a Gauss-Newton iteration; and under
"""

import dataclasses
import math
import warnings

import pytest
import torch

from diff_gaussian_rasterization_tpu_torch.models import lie, slam
from diff_gaussian_rasterization_tpu_torch.ops.kernels import gauss_newton as gn
from diff_gaussian_rasterization_tpu_torch.scenes import tracking_frame

pytestmark = pytest.mark.cuda

ANGLES = [0.0, math.sqrt(1e-13), 1e-3, 0.5]
HUBER = dict(sil_threshold=0.99, sqc=1.0, sqd=0.5, huber=0.05)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def start_view(dev):
    v = torch.eye(4, dtype=torch.float64)
    v[:3, :3] = lie.exp_so3(torch.tensor([0.3, -0.5, 0.2],
                                         dtype=torch.float64)).T
    v[3, :3] = torch.tensor([0.1, -0.2, 1.5], dtype=torch.float64)
    return v.to(torch.float32).to(dev)


def twist(angle, dev):
    g = torch.Generator().manual_seed(5)
    xi = torch.randn(6, generator=g, dtype=torch.float64)
    xi[:3] *= 0.05
    xi[3:] *= angle / xi[3:].norm()
    return xi.to(torch.float32).to(dev)


@pytest.mark.parametrize("angle", ANGLES)
def test_twist_tangents_match_jacfwd_in_float64(dev, angle):
    v0, xi = start_view(dev), twist(angle, dev)
    view, tan = gn.twist_tangents(v0, xi)
    v64, x64 = v0.double(), xi.double()
    want = torch.func.jacfwd(lambda x: lie.apply_twist(v64, x))(x64)
    want = want.movedim(-1, 0)
    for got, ref in ((view, lie.apply_twist(v64, x64)), (tan, want)):
        assert got.dtype == torch.float32
        tol = 4 * 2.0 ** -24 * float(ref.abs().max())
        torch.testing.assert_close(got.double(), ref, rtol=0, atol=tol)
    again = gn.twist_tangents(v0, xi)
    assert torch.equal(again[0], view) and torch.equal(again[1], tan)
    only, none = gn.twist_tangents(v0, xi, tangents=False)
    assert none is None and torch.equal(only, view)


def images(h, w, seed, dev):
    """A render, its six tangent images and a target, as the tracker's:
    a quarter of the silhouette below 0.99, a tenth of the target depth
    invalid, some silhouette at 0 and at 1e-6; the tangents cropped views
    (a wider image cut to ``w``), as the dual render returns them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    sil = torch.where(r(h, w) < 0.25, r(h, w), 0.99 + 0.01 * r(h, w))
    sil[0, :4] = 0.0
    sil[1, :4] = 1e-6
    depth = (1.0 + 2.0 * r(h, w)) * sil
    gt_depth = torch.where(r(h, w) < 0.1, torch.zeros(h, w, device=dev),
                           1.0 + 2.0 * r(h, w))
    wide = w + 8
    tans = ((r(6, 3, h, wide) - 0.5)[..., :w],
            (3.0 * (r(6, h, wide) - 0.5))[..., :w],
            (0.1 * (r(6, h, wide) - 0.5))[..., :w])
    return (r(3, h, w), depth, sil, r(3, h, w), gt_depth), tans


def assert_sums_close(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            atol = 1e-5 * float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("size", [(680, 1200), (240, 320)])
def test_gn_reduce_matches_plain_and_repeats(dev, size, full):
    ims, tans = images(*size, seed=size[1], dev=dev)
    tans = tans if full else None
    before = gn.launches["gn_reduce"]
    got = gn.gn_reduce(*ims, tangents=tans, **HUBER)
    again = gn.gn_reduce(*ims, tangents=tans, **HUBER)
    assert gn.launches["gn_reduce"] == before + 2
    want = gn.gn_reduce_reference(*ims, tangents=tans, **HUBER)
    assert_sums_close(got, want)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    if full:
        assert torch.equal(got[0], got[0].T)
        # the cost of the cost-only reduction is the full one's, bit for bit
        assert torch.equal(gn.gn_reduce(*ims, **HUBER)[2], got[2])


def state_pair(dev, ref_cost):
    """Two equal LM states with pending steps and a reference cost."""
    st = gn.LmState.start(1e-4, 3, torch.zeros(6, device=dev))
    st.vec[:30] = torch.linspace(-0.01, 0.01, 30, device=dev)
    st.vec[gn.REF_COST] = ref_cost
    st.vec[gn.BEST_COST] = ref_cost
    copy = gn.LmState(st.vec.clone(), st.costs.clone(), st.accept.clone())
    return st, copy


def assert_states_close(a, b, slots=()):
    torch.testing.assert_close(a.vec, b.vec, rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    assert bool(a.accepted) == bool(b.accepted)
    for i in slots:
        torch.testing.assert_close(a.costs[i], b.costs[i], rtol=1e-5,
                                   atol=0.0)


def with_nan_tangent(ims, tans):
    """The tangents with a NaN at a counted pixel: H and the step are not
    finite, the cost is."""
    sil, gt_depth = ims[2], ims[4]
    y, x = ((sil > HUBER["sil_threshold"]) & (gt_depth > 0)).nonzero()[0]
    dcolor = tans[0].clone()
    dcolor[2, 1, y, x] = float("nan")
    return (dcolor, tans[1], tans[2])


@pytest.mark.parametrize("case", ["accept", "reject", "singular"])
def test_lm_stage_deferred_matches_plain(dev, case):
    ims, tans = images(240, 320, seed=7, dev=dev)
    if case == "singular":
        tans = with_nan_tangent(ims, tans)
    a, b = state_pair(dev, 0.0 if case == "reject" else math.inf)
    dx_before = a.vec[gn.DX:gn.DX + 6].clone()
    gn.gn_reduce(*ims, tangents=tans, lm=(a, gn.DEFERRED, 1), **HUBER)
    gn.gn_reduce_reference(*ims, tangents=tans, lm=(b, gn.DEFERRED, 1),
                           **HUBER)
    assert_states_close(a, b, slots=[1])
    assert bool(a.accepted) == (case != "reject")
    dx = a.vec[gn.DX:gn.DX + 6]
    if case == "accept":
        assert not torch.equal(dx, 0.5 * dx_before)
    else:  # rejected, or accepted with a non-finite step: half the step
        assert torch.equal(dx, 0.5 * dx_before)
    torch.testing.assert_close(a.xi, a.vec[gn.ANCHOR:gn.ANCHOR + 6] + dx,
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["accept", "reject", "singular"])
def test_lm_stage_line_search_matches_plain(dev, case):
    ims, tans = images(240, 320, seed=8, dev=dev)
    if case == "singular":
        tans = with_nan_tangent(ims, tans)
    a, b = state_pair(dev, math.inf)
    for st, reduce in ((a, gn.gn_reduce), (b, gn.gn_reduce_reference)):
        reduce(*ims, tangents=tans, lm=(st, gn.PROPOSE, 2), **HUBER)
    assert_states_close(a, b, slots=[2])
    # the trial's render: the target moved towards the render lowers the
    # cost (accepted unless the step is not finite), away raises it
    color, rgb = ims[0], ims[3]
    toward = rgb + (0.5 if case != "reject" else -0.5) * (color - rgb)
    trial = (ims[0], ims[1], ims[2], toward, ims[4])
    for st, reduce in ((a, gn.gn_reduce), (b, gn.gn_reduce_reference)):
        reduce(*trial, lm=(st, gn.DECIDE, 0), **HUBER)
    assert_states_close(a, b)
    assert bool(a.accepted) == (case == "accept")
    for st, reduce in ((a, gn.gn_reduce), (b, gn.gn_reduce_reference)):
        reduce(*trial, lm=(st, gn.FINAL, 0), **HUBER)
    assert_states_close(a, b)


def tum_like(ts):
    """The TUM cells' tracking on the record frame: line search, fresh
    binning, their threshold and depth weight, 3 + 2 iterations."""
    return ts._replace(tcfg=dataclasses.replace(
        ts.tcfg, line_search=True, freeze_binning=False, sil_threshold=0.85,
        w_depth=1.5, coarse_iters=3, iters=2))


def track(ts):
    return slam.track_frame(ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg,
                            ts.camera)


@pytest.fixture(scope="module")
def record_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return tracking_frame(device=torch.device("cuda"))


@pytest.mark.parametrize("variant", ["replica", "tum"])
def test_track_frame_kernels_match_plain_path(record_frame, variant,
                                              monkeypatch):
    ts = record_frame if variant == "replica" else tum_like(record_frame)
    track(ts)
    gn.reset_launches()

    def refuse(*a, **k):
        raise AssertionError("torch.func on the tracker's CUDA path")

    binns = []
    with monkeypatch.context() as m:
        for name in ("jacfwd", "jvp", "vmap"):
            m.setattr(torch.func, name, refuse)
        view, cost, costs = slam.track_frame(
            ts.model, ts.view0, ts.frame, ts.cfg, ts.tcfg, ts.camera,
            binnings=binns)
        torch.cuda.synchronize()
    launches = dict(gn.launches)
    levels = ts.tcfg.pyramid
    iters = ts.tcfg.coarse_iters + ts.tcfg.iters
    costs_ = ts.tcfg.line_search * (iters + levels)   # line search's renders
    assert launches == {"twist_tangents": iters + costs_ + levels,
                        "gn_reduce": iters + costs_}
    # each level adds its final cost (line search) and its view
    per_level = 2 * ts.tcfg.line_search + 1
    assert (launches["twist_tangents"] + launches["gn_reduce"]
            - per_level * levels <= 4 * iters)

    # the reported cost: the plain reduction's at the reported view, with
    # the full level's frozen binning (Replica) or a fresh one (TUM)
    t = ts.tcfg
    with torch.no_grad():
        out = slam.render_model(
            ts.model, ts.camera.replace(viewmatrix=view), ts.cfg,
            gt_depth=ts.frame.depth, **({"binn": binns[-1]} if binns else {}))
    want = gn.gn_reduce_reference(
        out.color, out.depth[0], out.opacity_map[0], ts.frame.rgb,
        ts.frame.depth, sil_threshold=t.sil_threshold,
        sqc=math.sqrt(t.w_color), sqd=math.sqrt(t.w_depth), huber=t.huber)[2]
    torch.testing.assert_close(cost, want, rtol=1e-5, atol=0.0)

    with monkeypatch.context() as m:
        m.setattr(gn, "twist_tangents", gn.twist_tangents_reference)
        m.setattr(gn, "gn_reduce", gn.gn_reduce_reference)
        view_p, cost_p, costs_p = track(ts)
    print(f"{variant}: view gap {float((view - view_p).abs().max())}, "
          f"costs {costs.tolist()} / plain {costs_p.tolist()}")
    assert float((view - view_p).abs().max()) <= 1e-6
    torch.testing.assert_close(costs, costs_p, rtol=5e-3, atol=0.0)
    assert float((view - ts.camera.viewmatrix).abs().max()) < 1e-3


@pytest.mark.parametrize("variant", ["replica", "tum"])
def test_track_frame_waits_not_in_the_tracking_layer(record_frame, variant):
    ts = record_frame if variant == "replica" else tum_like(record_frame)
    track(ts)
    torch.cuda.synchronize()
    tracking_files = ("models/slam.py", "models/lie.py",
                      "ops/kernels/gauss_newton.py")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            track(ts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = sorted({f"{w.filename}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message)})
    print(f"{variant}: host waits at {sites}")
    assert not [s for s in sites
                if any(f in s.replace("\\", "/") for f in tracking_files)]
