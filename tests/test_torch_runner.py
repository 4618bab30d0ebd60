"""The port's SLAM runner against the JAX package's, on the CPU.

Against the JAX package: ``SLAMConfig``'s fields; ``backproject``
bit-equal (hole seeding from one silhouette given to both); ``add_gaussians``
bit-equal in every field but ``scales_log``, within one float32 ulp
(XLA:CPU's float32 ``log`` is not correctly rounded; PyTorch's is);
``_select_window`` (random and nearest) equal; ``init_slam`` and two
``slam_step``s on ``test_runner.py::test_slam_loop_minimal_quick``'s world
(the same seeds, instance budget and keyframes, the same active mask, the
losses at rtol 1e-3 and the poses at atol 1e-4, ``test_torch_tracking.py``'s
tolerances); ``reanchor_map`` at atol 1e-5; ``refine_keyframes`` without a
config (the native solver) at atol 1e-5 and with one (keyframes re-tracked,
then ``refine_poses_sharded``) at atol 1e-4, each on one state carried
across from the JAX package.

The port's own versions of ``test_runner.py``'s coverage trigger,
cooldown, budget regrowth, relocalization and checkpoint-resume tests (the
resumed run bit-equal to the one never stopped); a ``mesh`` that is not
a DeviceMesh raising ``TypeError``, and a step and a refinement on a
one-rank gloo mesh bit-equal to one device's.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.io import synthetic as jsyn
from diff_gaussian_rasterization_tpu.models import lie as jlie
from diff_gaussian_rasterization_tpu.models import runner as jrunner
from diff_gaussian_rasterization_tpu.models import slam as jslam
from diff_gaussian_rasterization_tpu_torch.camera import Camera, look_at
from diff_gaussian_rasterization_tpu_torch.convert import (
    gaussian_model_from_numpy)
from diff_gaussian_rasterization_tpu_torch.io import synthetic
from diff_gaussian_rasterization_tpu_torch.models import lie, runner, slam
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    PARAM_FIELDS)
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import make_mesh

from test_torch_rasterize import port_config
from torch_dist_cases import one_rank_world

torch.set_num_threads(2)

FIELDS = PARAM_FIELDS + ("active",)
CFG_J = JaxConfig(tile_h=8, tile_w=8, chunk=16, instance_multiplier=12)
CFG = port_config(CFG_J)
H, W = 24, 32


def cams(h=H, w=W):
    return (JaxCamera(viewmatrix=jnp.eye(4), tanfovx=0.7, tanfovy=0.55,
                      height=h, width=w),
            Camera(viewmatrix=torch.eye(4), tanfovx=0.7, tanfovy=0.55,
                   height=h, width=w))


def np_fields(model):
    return {f: (getattr(model, f).detach().numpy()
                if torch.is_tensor(getattr(model, f))
                else np.asarray(getattr(model, f))) for f in FIELDS}


def assert_models(a, b, means_atol=0.0, adam_steps=0, mcfg=None):
    """Port model ``a`` against JAX model ``b``: the active mask and every
    field bit-equal, ``scales_log`` within one ulp.  ``means_atol`` > 0
    compares every float field at that atol instead, plus, after
    ``adam_steps`` mapping steps, a tenth of the field's learning rate a
    step (``test_torch_mapping.py``'s rule: Adam moves an entry by about
    lr * sign(g), and a gradient at rounding level may take either
    sign)."""
    fa, fb = np_fields(a), np_fields(b)
    np.testing.assert_array_equal(fa["active"], fb["active"])
    lrs = {} if mcfg is None else dict(
        means3D=mcfg.lr_means, scales_log=mcfg.lr_scales,
        rotations=mcfg.lr_rotations, opacities_logit=mcfg.lr_opacities,
        sh=mcfg.lr_sh)
    for f in PARAM_FIELDS:
        if means_atol:
            atol = means_atol + adam_steps * lrs.get(f, 0.0) / 10
            np.testing.assert_allclose(fa[f], fb[f], atol=atol,
                                       rtol=1e-5, err_msg=f)
        elif f == "scales_log":
            np.testing.assert_array_max_ulp(fa[f], fb[f], maxulp=1)
        else:
            np.testing.assert_array_equal(fa[f], fb[f], err_msg=f)


def test_slam_config_matches_jax():
    a = dataclasses.fields(jrunner.SLAMConfig)
    b = dataclasses.fields(runner.SLAMConfig)
    assert [f.name for f in a] == [f.name for f in b]
    for fa, fb in zip(a, b):
        if fa.default is not dataclasses.MISSING:
            assert fa.default == fb.default, fa.name
    with pytest.raises(ValueError, match="window_select"):
        runner.SLAMConfig(window_select="nearset")


def seed_frame(seed=0, h=H, w=W):
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    depth = np.where(rng.uniform(size=(h, w)) < 0.2, 0.0,
                     rng.uniform(0.5, 4.0, (h, w))).astype(np.float32)
    view = np.asarray(jsyn.orbit_trajectory(5)[3])
    return rgb, depth, view


@pytest.mark.parametrize("stride", [1, 3, 4])
def test_backproject_matches_jax(stride):
    rgb, depth, view = seed_frame()
    cj, ct = cams()
    a = jrunner.backproject(jslam.Frame(jnp.asarray(rgb), jnp.asarray(depth)),
                            jnp.asarray(view), cj, stride)
    b = runner.backproject(slam.Frame(torch.as_tensor(rgb),
                                      torch.as_tensor(depth)),
                           torch.as_tensor(view.copy()), ct, stride)
    for x, y in zip(a, b):
        assert y.dtype == torch.float32
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    assert b[0].shape[0] > 0


def test_hole_seeding_matches_jax():
    """The keyframe seeding of ``slam_step`` given one silhouette: the
    pixels below 0.5 backprojected, bit-equal."""
    rgb, depth, view = seed_frame(seed=1)
    sil = np.random.RandomState(2).uniform(0, 1, (H, W)).astype(np.float32)
    cj, ct = cams()
    holes_j = jslam.Frame(rgb=jnp.asarray(rgb), depth=jnp.where(
        jnp.asarray(sil) < 0.5, jnp.asarray(depth), 0.0))
    d = torch.as_tensor(depth)
    holes_t = slam.Frame(rgb=torch.as_tensor(rgb), depth=torch.where(
        torch.as_tensor(sil) < 0.5, d, torch.zeros_like(d)))
    a = jrunner.backproject(holes_j, jnp.asarray(view), cj, 2)
    b = runner.backproject(holes_t, torch.as_tensor(view.copy()), ct, 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("n_free", [40, 7])
def test_add_gaussians_matches_jax(n_free):
    rng = np.random.RandomState(5)
    cap = 64
    active = np.ones(cap, bool)
    active[rng.choice(cap, n_free, replace=False)] = False
    fields = dict(
        means3D=rng.normal(size=(cap, 3)).astype(np.float32),
        scales_log=rng.normal(size=(cap, 3)).astype(np.float32),
        rotations=rng.normal(size=(cap, 4)).astype(np.float32),
        opacities_logit=rng.normal(size=(cap, 1)).astype(np.float32),
        sh=rng.normal(size=(cap, 1, 3)).astype(np.float32), active=active)
    rgb, depth, view = seed_frame(seed=3)
    cj, _ = cams()
    seeds = [np.asarray(x) for x in jrunner.backproject(
        jslam.Frame(jnp.asarray(rgb), jnp.asarray(depth)),
        jnp.asarray(view), cj, 6)][:3]
    seeds = [s[:12] for s in seeds]
    jm = jrunner.GaussianModel(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    jm2, jn = jrunner.add_gaussians(jm, *[jnp.asarray(s) for s in seeds])
    tm = gaussian_model_from_numpy(fields, device="cpu")
    params = [getattr(tm, f) for f in PARAM_FIELDS]
    tn = runner.add_gaussians(tm, *[torch.as_tensor(s) for s in seeds])
    assert tn == int(jn) == min(12, n_free)
    assert all(getattr(tm, f) is p for f, p in zip(PARAM_FIELDS, params))
    assert_models(tm, jm2)


def kf_line_views():
    from diff_gaussian_rasterization_tpu.camera import look_at
    return [np.asarray(look_at((float(x), 0.1 * x * x, 0.0),
                               (float(x) + 0.3 * np.sin(x), 0.0, 2.0)))
            for x in range(7)]


@pytest.mark.parametrize("select", ["random", "nearest"])
def test_select_window_matches_jax(select):
    views = kf_line_views()
    for k in (1, 2, 3, 5, 7):
        js = jrunner.SLAMState(model=None, opt_state=None, dstate=None,
                               kf_views=[jnp.asarray(v) for v in views[:k]],
                               kf_frames=[None] * k, est_views=[], rng=None)
        ts = runner.SLAMState(model=None, opt=None, dstate=None,
                              kf_views=[torch.as_tensor(v)
                                        for v in views[:k]],
                              kf_frames=[None] * k, est_views=[], rng=None)
        for window in (1, 2, 3, 4):
            for frame_idx in (3, 7, 12):
                a = jrunner._select_window(
                    js, jrunner.SLAMConfig(window=window,
                                           window_select=select), frame_idx)
                b = runner._select_window(
                    ts, runner.SLAMConfig(window=window,
                                          window_select=select), frame_idx)
                np.testing.assert_array_equal(b, a)
                assert b[0] == k - 1


def minimal_world():
    """``test_slam_loop_minimal_quick``'s world and config, in both
    packages (the port's frames are the JAX package's, carried across)."""
    cj, ct = cams()
    gt = jsyn.random_room_model(capacity=256, n=256, seed=3)
    views = jsyn.orbit_trajectory(3)
    frames = jsyn.render_sequence(gt, views, cj, CFG_J)
    kw = dict(capacity=1024, keyframe_every=2, map_every=2, window=2,
              seed_every_px=4, init_iters=2, motion_model=False)
    sj = jrunner.SLAMConfig(
        raster=CFG_J, tracking=jslam.TrackingConfig(iters=2,
                                                    sil_threshold=0.5),
        mapping=jslam.MappingConfig(iters=2), **kw)
    st = runner.SLAMConfig(
        raster=CFG, tracking=slam.TrackingConfig(iters=2, sil_threshold=0.5),
        mapping=slam.MappingConfig(iters=2), **kw)
    t = lambda x: torch.as_tensor(np.array(x))
    tframes = [slam.Frame(t(f.rgb), t(f.depth)) for f in frames]
    return dict(cj=cj, ct=ct, views=views, frames=frames, sj=sj, st=st,
                tviews=t(views), tframes=tframes)


def test_init_and_two_steps_match_jax():
    w = minimal_world()
    a = jrunner.init_slam(jnp.asarray(w["views"][0]), w["frames"][0],
                          w["cj"], w["sj"])
    b = runner.init_slam(w["tviews"][0], w["tframes"][0], w["ct"], w["st"])
    assert b.raster.max_instances == a.raster.max_instances
    mcfg = w["st"].mapping
    assert_models(b.model, a.model, means_atol=1e-5, adam_steps=2,
                  mcfg=mcfg)
    assert int(b.model.num_active) == int(a.model.num_active) > 0
    costs_a, costs_b = [], []
    for i in (1, 2):
        a, la = jrunner.slam_step(a, w["frames"][i], w["cj"], w["sj"], i)
        b, lb = runner.slam_step(b, w["tframes"][i], w["ct"], w["st"], i)
        costs_a.append(la)
        costs_b.append(lb)
        assert b.kf_idx == a.kf_idx
        assert b.raster.max_instances == a.raster.max_instances
        np.testing.assert_array_equal(b.model.active.numpy(),
                                      np.asarray(a.model.active))
    np.testing.assert_allclose(costs_b, costs_a, rtol=1e-3)
    assert len(b.est_views) == 3 and len(b.kf_views) == 2
    for va, vb in zip(a.est_views, b.est_views):
        np.testing.assert_allclose(vb.numpy(), np.asarray(va), atol=1e-4)
    # 2 bootstrap steps and frame 2's round of 2
    assert_models(b.model, a.model, means_atol=1e-5, adam_steps=4,
                  mcfg=mcfg)
    assert all(np.isfinite(c) for c in costs_b)


def carried_state(w, perturb=True):
    """A fixed state in both packages: the room model, keyframes 0, 1, 2 of
    the 3-frame orbit (the last moved by a twist when ``perturb``), and
    the trajectory; the JAX one's fields carried across to the port."""
    gt = jsyn.random_room_model(capacity=256, n=256, seed=3)
    kf = [jnp.asarray(v) for v in w["views"]]
    if perturb:
        kf[-1] = jlie.apply_twist(kf[-1], jnp.asarray(
            [0.02, -0.015, 0.01, 0.015, -0.01, 0.015], jnp.float32))
    js = jrunner.SLAMState(model=gt, opt_state=None, dstate=None,
                           kf_views=list(kf), kf_frames=list(w["frames"]),
                           est_views=list(kf), rng=None, kf_idx=[0, 1, 2],
                           raster=CFG_J.replace(max_instances=4096))
    t = lambda x: torch.as_tensor(np.array(x))
    ts = runner.SLAMState(
        model=gaussian_model_from_numpy(np_fields(gt), device="cpu"),
        opt=None, dstate=None, kf_views=[t(v) for v in kf],
        kf_frames=list(w["tframes"]), est_views=[t(v) for v in kf],
        rng=None, kf_idx=[0, 1, 2], raster=CFG.replace(max_instances=4096))
    return js, ts


def test_reanchor_map_matches_jax():
    w = minimal_world()
    js, ts = carried_state(w)
    old = [np.asarray(v) for v in js.kf_views]
    new = [np.asarray(jlie.apply_twist(jnp.asarray(v), jnp.asarray(
        [0.01 * i, -0.02, 0.005, 0.01, 0.0, -0.01 * i], jnp.float32)))
        for i, v in enumerate(old)]
    a = jrunner.reanchor_map(js.model, old, new)
    means = ts.model.means3D
    runner.reanchor_map(ts.model, old, new)
    assert ts.model.means3D is means
    assert_models(ts.model, a, means_atol=1e-5)
    assert float((ts.model.means3D.detach() - torch.as_tensor(
        np.asarray(js.model.means3D))).abs().max()) > 1e-3


@pytest.mark.parametrize("with_config", [False, True])
def test_refine_keyframes_matches_jax(with_config):
    w = minimal_world()
    js, ts = carried_state(w)
    if with_config:
        kw = dict(refine_track_iters=2, refine_abs_weight=4.0)
        a = jrunner.refine_keyframes(
            js, dataclasses.replace(w["sj"], **kw), w["cj"])
        b = runner.refine_keyframes(
            ts, dataclasses.replace(w["st"], **kw), w["ct"])
        atol = 1e-4     # the re-tracks: test_torch_tracking.py's tolerance
    else:
        a = jrunner.refine_keyframes(js)
        b = runner.refine_keyframes(ts)
        atol = 1e-5
    for name in ("kf_views", "est_views"):
        for va, vb in zip(getattr(a, name), getattr(b, name)):
            assert vb.dtype == torch.float32
            np.testing.assert_allclose(vb.numpy(), np.asarray(va),
                                       atol=atol, err_msg=name)
    assert_models(b.model, a.model, means_atol=atol)
    if with_config:
        # the re-tracked edges move the perturbed keyframe (the odometry
        # chain alone has no residual)
        moved = float(np.abs(b.kf_views[-1].numpy() - np.asarray(
            carried_state(w)[0].kf_views[-1])).max())
        assert moved > 1e-3


# ---- the port's own versions of test_runner.py's loop tests -------------

def port_world(n_frames, seed=3, n=256, h=H, w=W):
    _, ct = cams(h, w)
    gt = synthetic.random_room_model(capacity=n, n=n, seed=seed,
                                     device="cpu")
    views = synthetic.orbit_trajectory(n_frames, device="cpu")
    return ct, views, synthetic.render_sequence(gt, views, ct, CFG)


def test_coverage_triggered_keyframe_fires_on_unmapped_territory():
    _, ct = cams()
    gt = synthetic.random_room_model(capacity=512, n=512, seed=1,
                                     device="cpu")
    eye = (0.0, 0.0, -0.5)
    views = torch.stack([look_at(eye, t, device="cpu")
                         for t in ((0.0, 0.0, 2.0), (2.0, 0.0, 0.3))])
    frames = synthetic.render_sequence(gt, views, ct, CFG)

    def run(min_cov):
        scfg = runner.SLAMConfig(
            raster=CFG, tracking=slam.TrackingConfig(iters=0),
            mapping=slam.MappingConfig(iters=2), capacity=2048,
            keyframe_every=100, map_every=100, window=2, seed_every_px=3,
            init_iters=2, motion_model=False, kf_min_coverage=min_cov)
        state = runner.init_slam(views[0], frames[0], ct, scfg)
        # perfect odometry stand-in: iters=0 keeps est_views[-1]
        state.est_views[-1] = views[1]
        state, _ = runner.slam_step(state, frames[1], ct, scfg, 1)
        return state

    trig, base = run(0.9), run(0.0)
    assert len(base.kf_views) == 1
    assert len(trig.kf_views) == 2 and trig.kf_idx[-1] == 1
    assert int(trig.model.num_active) > int(base.model.num_active)


def test_coverage_trigger_cooldown(monkeypatch):
    _, ct = cams()

    class FakeOut:
        opacity_map = torch.zeros((1, H, W))
        num_rendered = torch.tensor(0)

    monkeypatch.setattr(runner, "render_model",
                        lambda *a, **k: FakeOut())
    monkeypatch.setattr(runner, "track_frame",
                        lambda m, v0, *a, **k: (v0, torch.tensor(1.0), None))
    monkeypatch.setattr(runner, "mapping_round",
                        lambda m, o, d, *a, **k: (d, torch.tensor(0.0)))
    monkeypatch.setattr(runner, "backproject",
                        lambda *a, **k: (torch.zeros((0, 3)),) * 3)
    frame = slam.Frame(rgb=torch.zeros((3, H, W)), depth=torch.ones((H, W)))
    scfg = runner.SLAMConfig(keyframe_every=100, map_every=100,
                             kf_min_coverage=0.9, kf_coverage_cooldown=3,
                             motion_model=False)
    state = runner.SLAMState(
        model=None, opt=None, dstate=None, kf_views=[torch.eye(4)],
        kf_frames=[frame], est_views=[torch.eye(4)],
        rng=torch.Generator().manual_seed(0), kf_idx=[0],
        raster=CFG)
    for i in range(1, 10):
        state, _ = runner.slam_step(state, frame, ct, scfg, i)
    assert state.kf_idx == [0, 3, 6, 9], state.kf_idx


def loop_config(**kw):
    base = dict(raster=CFG, tracking=slam.TrackingConfig(
        iters=3, sil_threshold=0.5), mapping=slam.MappingConfig(iters=2),
        capacity=1024, keyframe_every=2, map_every=2, window=2,
        seed_every_px=4, init_iters=4, motion_model=False)
    base.update(kw)
    return runner.SLAMConfig(**base)


def test_slam_rebudgets_when_scene_outgrows_instance_budget():
    ct, views, frames = port_world(5)
    scfg = loop_config()

    def run(shrink_to):
        state = runner.init_slam(views[0], frames[0], ct, scfg)
        budgets = [state.raster.max_instances]
        for i in range(1, 5):
            if shrink_to and i == 2:
                state.raster = state.raster.replace(max_instances=shrink_to)
            state, _ = runner.slam_step(state, frames[i], ct, scfg, i)
            budgets.append(state.raster.max_instances)
        return state, budgets

    base, _ = run(0)
    # the frame-2 keyframe's true count, from an unshrunk run
    probe = runner.init_slam(views[0], frames[0], ct, scfg)
    probe, _ = runner.slam_step(probe, frames[1], ct, scfg, 1)
    with torch.no_grad():
        n2 = int(runner.render_model(probe.model, ct.replace(
            viewmatrix=probe.est_views[-1]), probe.raster).num_rendered)
    shrink = int(n2 / 0.9)      # above the count, past 80% of it
    assert shrink < base.raster.max_instances
    tight, budgets = run(shrink)
    assert budgets[2] > shrink, budgets
    for i, (a, b) in enumerate(zip(base.est_views, tight.est_views)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0,
                                   msg=f"frame {i} diverged after re-budget")


def test_slam_session_checkpoint_resume(tmp_path):
    """The restored session continues bit for bit like the one never
    stopped."""
    ct, views, frames = port_world(5)
    scfg = loop_config(mapping=slam.MappingConfig(iters=2, lr_decay=0.5,
                                                  lr_decay_steps=3))
    state = runner.init_slam(views[0], frames[0], ct, scfg)
    for i in (1, 2):
        state, _ = runner.slam_step(state, frames[i], ct, scfg, i)
    path = str(tmp_path / "slam.pt")
    runner.save_slam(path, state)
    restored = runner.load_slam(path, scfg, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(restored.model, f),
                           getattr(state.model, f)), f
    assert restored.kf_idx == state.kf_idx
    assert restored.raster.max_instances == state.raster.max_instances
    assert restored.track_costs == state.track_costs
    for i in (3, 4):
        state, la = runner.slam_step(state, frames[i], ct, scfg, i)
        restored, lb = runner.slam_step(restored, frames[i], ct, scfg, i)
        assert la == lb
    assert torch.equal(torch.stack(state.est_views),
                       torch.stack(restored.est_views))
    for f in FIELDS:
        assert torch.equal(getattr(restored.model, f),
                           getattr(state.model, f)), f
    for ga, gb in zip(state.opt.adam.param_groups,
                      restored.opt.adam.param_groups):
        assert ga["lr"] == gb["lr"]
    assert torch.equal(state.rng.get_state(), restored.rng.get_state())


def test_relocalization_rescues_bad_motion_init():
    ct, views, frames = port_world(8)
    scfg = loop_config(tracking=slam.TrackingConfig(iters=4,
                                                    sil_threshold=0.5),
                       init_iters=10, reloc_spike=3.0, reloc_candidates=2,
                       reloc_track_iters=12)
    state = runner.init_slam(views[0], frames[0], ct, scfg)
    for i in range(1, 6):
        state, _ = runner.slam_step(state, frames[i], ct, scfg, i)
    assert len(state.track_costs) == 5
    state.est_views[-1] = lie.apply_twist(state.est_views[-1], torch.tensor(
        [0.4, -0.3, 0.35, 0.25, -0.3, 0.2]))
    lost = copy.copy(state)
    lost.est_views = list(state.est_views)
    lost.track_costs = list(state.track_costs)
    state, cost_reloc = runner.slam_step(state, frames[6], ct, scfg, 6)
    lost, cost_lost = runner.slam_step(
        lost, frames[6], ct, dataclasses.replace(scfg, reloc_spike=0.0), 6)

    def pose_err(a, b):
        ra, rb = a[:3, :3].numpy(), b[:3, :3].numpy()
        cos = np.clip((np.trace(ra.T @ rb) - 1) / 2, -1, 1)
        return (float(np.arccos(cos)),
                float(np.linalg.norm(a[3, :3].numpy() - b[3, :3].numpy())))

    r_reloc, t_reloc = pose_err(state.est_views[-1], views[6])
    r_lost, t_lost = pose_err(lost.est_views[-1], views[6])
    assert np.isfinite(cost_reloc) and np.isfinite(cost_lost)
    assert r_lost > 0.2, (r_lost, t_lost)
    assert r_reloc < 0.3 * r_lost, (r_reloc, r_lost)
    assert t_reloc < 0.3 * t_lost, (t_reloc, t_lost)


def test_mesh_raises():
    """A ``SLAMConfig.mesh`` that is not a DeviceMesh raises in every
    meshed entry; on a one-rank gloo mesh a step and the edge-sharded
    refinement give the one-device state bit for bit."""
    ct, views, frames = port_world(2)
    with pytest.raises(TypeError):
        runner.init_slam(views[0], frames[0], ct,
                         loop_config(mesh=object()))
    state = runner.init_slam(views[0], frames[0], ct, loop_config())
    with pytest.raises(TypeError):
        runner.slam_step(state, frames[1], ct, loop_config(mesh=object()), 1)
    state.kf_views += [views[1], views[1]]
    state.kf_frames += [frames[1], frames[1]]
    state.kf_idx += [1, 1]
    meshed = copy.deepcopy(state)
    with pytest.raises(TypeError):
        runner.refine_keyframes(state, loop_config(mesh=object(),
                                                   refine_track_iters=0), ct)
    state = copy.deepcopy(meshed)
    with one_rank_world():
        scfg = loop_config(mesh=make_mesh((1, 1), ("kf", "tile"),
                                          backend="gloo", device="cpu"),
                           refine_track_iters=2)
        runner.slam_step(meshed, frames[1], ct, scfg, 1)
        runner.refine_keyframes(meshed, scfg, ct)
    scfg = loop_config(refine_track_iters=2)
    runner.slam_step(state, frames[1], ct, scfg, 1)
    runner.refine_keyframes(state, scfg, ct)
    for a, b in zip(state.est_views + state.kf_views,
                    meshed.est_views + meshed.kf_views):
        assert torch.equal(a, b)
    for k, v in np_fields(state.model).items():
        np.testing.assert_array_equal(v, np_fields(meshed.model)[k],
                                      err_msg=k)


def test_runner_keeps_the_optimizer_parameters():
    """The map's parameters are the optimizer's tensors through a whole
    step: ``add_gaussians`` and mapping write into them, never replace
    them."""
    ct, views, frames = port_world(3)
    scfg = loop_config()
    state = runner.init_slam(views[0], frames[0], ct, scfg)
    held = [p for g in state.opt.adam.param_groups for p in g["params"]]
    assert all(p is getattr(state.model, f)
               for p, f in zip(held, PARAM_FIELDS))
    for i in (1, 2):
        state, _ = runner.slam_step(state, frames[i], ct, scfg, i)
    assert all(p is getattr(state.model, f)
               for p, f in zip(held, PARAM_FIELDS))
