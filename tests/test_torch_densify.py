"""The port's densify, prune and ``mapping_round`` against the JAX
package's, on the CPU.

``densify_and_prune`` is given the JAX run's split noise
(``jax.random.normal(key, (max_new, 3))``) and compared on clone and split
cases, tied scores, a small ``max_new``, more candidates than free slots
and the opacity cull.  Bit-equal: the active mask, the number spawned, and
every row that no transcendental function touches.  Two values pass
through one, and XLA:CPU's float32 ``exp`` and ``log`` are not correctly
rounded (about one value in ten differs by an ulp from PyTorch's, which
are): a split copy's mean (``mean + noise * exp(scales_log)``) and a split
row's ``scales_log - log(1.6)``; those rows are held at rtol 1e-6, atol
1e-7.  ``prune_by_uncertainty`` is bit-equal.  ``mapping_round`` (3
steps, densify every 2, uncertainty pruning) on ``test_torch_mapping.py``'s
window: the same active mask, the same slots spawned, and the parameters
within that file's tolerance (a tenth of each field's learning rate where
its gradient is live, at rtol 1e-5 elsewhere); on a one-rank gloo mesh
the same round bit for bit, and a ``mesh`` that is not a DeviceMesh
refused (``TypeError``).  Also the port's own
versions of ``test_slam.py``'s ``test_densify_clone_and_split`` and
``test_mapping_improves_model``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.models import gaussians as jgauss
from diff_gaussian_rasterization_tpu.models import slam as jslam
from diff_gaussian_rasterization_tpu_torch.camera import Camera
from diff_gaussian_rasterization_tpu_torch.convert import (
    gaussian_model_from_numpy)
from diff_gaussian_rasterization_tpu_torch.models import gaussians, slam
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    PARAM_FIELDS, DensifyState)
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import make_mesh

from test_torch_mapping import H, TANX, TANY, W, window
from test_torch_rasterize import CFG, port_config
from torch_dist_cases import one_rank_world

torch.set_num_threads(2)

FIELDS = PARAM_FIELDS + ("active",)


def fields_of(model):
    return {f: np.asarray(getattr(model, f)) if not torch.is_tensor(
        getattr(model, f)) else getattr(model, f).detach().numpy()
        for f in FIELDS}


def densify_world(cap=96, n=64, seed=0, op_low=0):
    """Numpy fields of a model with ``n`` active slots of ``cap`` (small and
    large scales), its densify statistics, and ``op_low`` active slots
    below the opacity cull."""
    rng = np.random.RandomState(seed)
    f = lambda a: np.asarray(a, np.float32)
    active = np.arange(cap) < n
    rng.shuffle(active)
    scales = np.where(rng.uniform(size=(cap, 3)) < 0.5, 0.004, 0.05)
    op = rng.normal(size=(cap, 1))
    op[np.flatnonzero(active)[:op_low]] = -7.0   # sigmoid ~ 9e-4
    fields = dict(
        means3D=f(rng.normal(size=(cap, 3))),
        scales_log=f(np.log(scales)),
        rotations=f(rng.normal(size=(cap, 4))),
        opacities_logit=f(op),
        sh=f(rng.normal(size=(cap, 1, 3))),
        active=active)
    grad = f(rng.uniform(0, 1e-3, cap))
    denom = f(rng.randint(0, 4, cap))
    return fields, grad, denom


CASES = {
    # mixed clone and split, capacity // 8 new slots
    "clone_split": dict(),
    # every score tied: sources in slot order
    "tied_scores": dict(tied=True),
    "max_new": dict(kw=dict(max_new=5)),
    # more candidates than free slots
    "few_free": dict(world=dict(cap=72, n=66)),
    "opacity_cull": dict(world=dict(op_low=9), kw=dict(opacity_cull=0.01)),
}


def assert_rows(a, b, exact_rows, field):
    """Bit-equal on ``exact_rows``, rtol 1e-6 / atol 1e-7 elsewhere."""
    np.testing.assert_array_equal(a[exact_rows], b[exact_rows],
                                  err_msg=field)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=field)


@pytest.mark.parametrize("case", list(CASES))
def test_densify_and_prune_matches_jax(case):
    spec = CASES[case]
    fields, grad, denom = densify_world(**spec.get("world", {}))
    if spec.get("tied"):
        grad[:] = 5e-4
        denom[:] = 1.0
    kw = dict(grad_threshold=2e-4, percent_dense=0.01, **spec.get("kw", {}))
    cap = fields["means3D"].shape[0]
    max_new = kw.get("max_new", 0) or cap // 8
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, (max_new, 3), jnp.float32))

    jm = jgauss.GaussianModel(**{k: jnp.asarray(v)
                                 for k, v in fields.items()})
    jd = jgauss.DensifyState(grad_accum=jnp.asarray(grad),
                             denom=jnp.asarray(denom))
    jm2, jd2, jn = jgauss.densify_and_prune(jm, jd, rng=key, **kw)

    tm = gaussian_model_from_numpy(fields, device="cpu")
    params = [getattr(tm, f) for f in PARAM_FIELDS]
    td = DensifyState(grad_accum=torch.as_tensor(grad),
                      denom=torch.as_tensor(denom))
    td2, tn = gaussians.densify_and_prune(tm, td,
                                          noise=torch.as_tensor(noise), **kw)
    # in place: the same parameter tensors
    assert all(getattr(tm, f) is p for f, p in zip(PARAM_FIELDS, params))
    assert int(tn) == int(jn)
    a, b = fields_of(tm), fields_of(jm2)
    np.testing.assert_array_equal(a["active"], b["active"])
    assert int(tn) > 0 or case == "opacity_cull"
    if case == "opacity_cull":
        assert a["active"].sum() < fields["active"].sum() + int(tn)
    # rows written through exp or log: split copies and split sources
    changed = np.any(a["scales_log"] != fields["scales_log"], axis=1)
    exact = ~changed
    for f in ("rotations", "opacities_logit", "sh"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert_rows(a["means3D"], b["means3D"], exact, "means3D")
    assert_rows(a["scales_log"], b["scales_log"], exact, "scales_log")
    assert float(td2.grad_accum.abs().max()) == 0.0
    assert float(td2.denom.abs().max()) == 0.0


def test_split_noise_is_seeded():
    a = gaussians.split_noise(torch.Generator().manual_seed(3), 6,
                              device="cpu")
    b = gaussians.split_noise(torch.Generator().manual_seed(3), 6,
                              device="cpu")
    assert a.shape == (6, 3) and torch.equal(a, b)
    assert torch.equal(gaussians.split_noise(None, 4, device="cpu"),
                       gaussians.split_noise(None, 4, device="cpu"))


def test_prune_by_uncertainty_matches_jax():
    fields, _, _ = densify_world(seed=3)
    rng = np.random.RandomState(4)
    cap = fields["means3D"].shape[0]
    u = rng.uniform(0, 2, (cap, 1)).astype(np.float32)
    npix = rng.randint(0, 4, (cap, 1)).astype(np.int32)
    jm = jgauss.prune_by_uncertainty(
        jgauss.GaussianModel(**{k: jnp.asarray(v)
                                for k, v in fields.items()}),
        jnp.asarray(u), jnp.asarray(npix), 0.4)
    tm = gaussian_model_from_numpy(fields, device="cpu")
    gaussians.prune_by_uncertainty(tm, torch.as_tensor(u),
                                   torch.as_tensor(npix), 0.4)
    np.testing.assert_array_equal(tm.active.numpy(), np.asarray(jm.active))
    assert tm.active.sum() < fields["active"].sum()


def test_mapping_config_matches_jax():
    a = [(f.name, f.default) for f in dataclasses.fields(
        jslam.MappingConfig)]
    b = [(f.name, f.default) for f in dataclasses.fields(
        slam.MappingConfig)]
    assert a == b


def round_model(seed=0):
    """``test_torch_mapping.small_model``'s draws in 96 slots, 64 active."""
    rng = np.random.RandomState(seed)
    cap, p = 96, 64
    means = rng.uniform(-1, 1, (cap, 3))
    means[:, 2] = rng.uniform(1.5, 4, cap)
    quats = rng.normal(size=(cap, 4))
    sh = rng.normal(scale=0.3, size=(cap, 1, 3))
    sh[:, 0] += 1.0
    f = lambda x: np.asarray(x, np.float32)
    return dict(means3D=f(means),
                scales_log=f(np.log(rng.uniform(0.05, 0.25, (cap, 3)))),
                rotations=f(quats / np.linalg.norm(quats, axis=1,
                                                   keepdims=True)),
                opacities_logit=f(rng.normal(size=(cap, 1))), sh=f(sh),
                active=np.arange(cap) < p)


def test_mapping_round_matches_jax(monkeypatch):
    cfg = CFG.replace(instance_multiplier=12)
    kw = dict(iters=3, densify_grad_threshold=1e-5, uncertainty_prune=0.0)
    fields = round_model()
    views, rgbs, depths, _ = window()
    j = jnp.asarray
    key = jax.random.PRNGKey(1)
    cam_j = JaxCamera(viewmatrix=jnp.eye(4), tanfovx=TANX, tanfovy=TANY,
                      height=H, width=W)

    # the uncertainty statistics of the JAX round's last step set the prune
    # threshold: the middle of the widest gap in the upper half of the
    # per-Gaussian means, so no mean sits at the threshold
    def run_jax(mcfg):
        jm = jgauss.GaussianModel(**{k: j(v) for k, v in fields.items()})
        opt_state = jslam.make_map_optimizer(mcfg).init(
            jslam.model_params(jm))
        jd = jgauss.DensifyState.zero(jm.capacity)
        return jslam.mapping_round(jm, opt_state, jd,
                                   (j(views), j(rgbs), j(depths)), cfg,
                                   mcfg, cam_j, key, densify_every=2)

    mcfg0 = jslam.MappingConfig(**kw)
    jm0, _, _, _ = run_jax(mcfg0)
    _, _, _, _, (gu, gn) = jslam.map_step(
        jm0, jslam.make_map_optimizer(mcfg0).init(jslam.model_params(jm0)),
        jgauss.DensifyState.zero(jm0.capacity), j(views), j(rgbs),
        j(depths), jnp.ones(2), cfg, mcfg0, H, W, TANX, TANY, 2)
    mean_u = np.sort((np.asarray(gu)[:, 0] / np.maximum(
        np.asarray(gn)[:, 0], 1))[np.asarray(gn)[:, 0] > 0])
    upper = mean_u[len(mean_u) // 2:]
    gap = int(np.argmax(np.diff(upper)))
    threshold = float(0.5 * (upper[gap] + upper[gap + 1]))
    kw["uncertainty_prune"] = threshold

    mcfg_j = jslam.MappingConfig(**kw)
    jm, _, jd, jl = run_jax(mcfg_j)

    noise = torch.as_tensor(np.array(jax.random.normal(
        key, (fields["means3D"].shape[0] // 8, 3), jnp.float32)))
    monkeypatch.setattr(slam, "split_noise", lambda *a, **k: noise)
    tm = gaussian_model_from_numpy(fields, device="cpu")
    mcfg_t = slam.MappingConfig(**kw)
    opt = slam.make_map_optimizer(tm, mcfg_t)
    t = torch.as_tensor
    cam_t = Camera(viewmatrix=torch.eye(4), tanfovx=TANX, tanfovy=TANY,
                        height=H, width=W)
    td, tl = slam.mapping_round(tm, opt, DensifyState.zero(96, device="cpu"),
                                (t(views), t(rgbs), t(depths)),
                                port_config(cfg), mcfg_t, cam_t,
                                densify_every=2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    a, b = fields_of(tm), fields_of(jm)
    np.testing.assert_array_equal(a["active"], b["active"])
    spawned = a["active"][64:].sum()
    assert spawned > 0, "the round densified nothing"
    # pruned by uncertainty (the densified slots start active)
    assert a["active"][:64].sum() < 64
    lrs = dict(means3D=mcfg_t.lr_means, scales_log=mcfg_t.lr_scales,
               rotations=mcfg_t.lr_rotations,
               opacities_logit=mcfg_t.lr_opacities, sh=mcfg_t.lr_sh)
    for k in PARAM_FIELDS:
        # three Adam steps move an entry by at most ~3 lr; the two
        # packages' steps differ where a gradient's sign is at rounding
        # level, by at most that
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                   atol=3 * lrs[k] / 10 + 1e-6, err_msg=k)
    np.testing.assert_array_equal(td.denom.numpy(), np.asarray(jd.denom))
    # the meshed round: a mesh that is not a DeviceMesh is refused, and on a
    # one-rank mesh (every axis one rank: no keyframe padding, no sharding)
    # the round is the one-device round bit for bit
    with pytest.raises(TypeError):
        slam.mapping_round(tm, opt, td, (t(views), t(rgbs), t(depths)),
                           port_config(cfg), mcfg_t, cam_t, mesh=object())
    with one_rank_world():
        mesh = make_mesh((1, 1), ("kf", "tile"), backend="gloo",
                         device="cpu")
        tm2 = gaussian_model_from_numpy(fields, device="cpu")
        td2, tl2 = slam.mapping_round(
            tm2, slam.make_map_optimizer(tm2, mcfg_t),
            DensifyState.zero(96, device="cpu"),
            (t(views), t(rgbs), t(depths)), port_config(cfg), mcfg_t, cam_t,
            densify_every=2, mesh=mesh)
    assert float(tl2) == float(tl)
    for k, v in fields_of(tm2).items():
        np.testing.assert_array_equal(v, a[k], err_msg=k)
    assert torch.equal(td2.grad_accum, td.grad_accum)


def test_densify_clone_and_split():
    """``test_slam.py::test_densify_clone_and_split``'s assertions."""
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        init_model)
    rng = np.random.RandomState(0)
    n, cap = 32, 128
    model = init_model(
        cap, sh_degree=0, means=rng.normal(size=(n, 3)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        scales=np.where(rng.uniform(size=(n, 3)) < 0.5, 0.002,
                        0.2).astype(np.float32),
        opacity=0.8, device="cpu")
    dstate = DensifyState(grad_accum=torch.full((cap,), 1.0),
                          denom=torch.ones(cap))
    dstate2, n_spawned = gaussians.densify_and_prune(
        model, dstate, grad_threshold=1e-3,
        generator=torch.Generator().manual_seed(0))
    assert int(n_spawned) > 0
    assert int(model.num_active) == n + int(n_spawned)
    assert bool(torch.isfinite(model.means3D).all())
    assert float(dstate2.grad_accum.max()) == 0.0


def test_mapping_improves_model():
    """``test_slam.py::test_mapping_improves_model``'s assertions, on the
    port's own synthetic world (``io.synthetic``, rendered by the port)."""
    from diff_gaussian_rasterization_tpu_torch.io.synthetic import (
        orbit_trajectory, random_room_model, render_sequence)
    h, w = 48, 64
    cam = Camera(viewmatrix=torch.eye(4), tanfovx=0.7, tanfovy=0.55,
                 height=h, width=w)
    cfg = port_config(CFG.replace(instance_multiplier=12))
    gt = random_room_model(capacity=512, n=512, seed=0, device="cpu")
    views = orbit_trajectory(4, device="cpu")
    frames = render_sequence(gt, views, cam, cfg)
    rng = np.random.RandomState(1)
    with torch.no_grad():
        gt.sh += torch.as_tensor(rng.normal(scale=0.2, size=gt.sh.shape),
                                 dtype=torch.float32)
        gt.opacities_logit -= 1.0
    mcfg = slam.MappingConfig(iters=25, lr_means=0.0, lr_scales=1e-3,
                              lr_rotations=0.0, lr_opacities=5e-2,
                              lr_sh=2e-2)
    opt = slam.make_map_optimizer(gt, mcfg)
    dstate = DensifyState.zero(512, device="cpu")
    kv = views[[0, 2]]
    kr = torch.stack([frames[0].rgb, frames[2].rgb])
    kd = torch.stack([frames[0].depth, frames[2].depth])
    losses = []
    for _ in range(mcfg.iters):
        loss, dstate, _ = slam.map_step(gt, opt, dstate, kv, kr, kd,
                                        torch.ones(2), cfg, mcfg, h, w,
                                        cam.tanfovx, cam.tanfovy, 2)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.6, losses[:3] + losses[-3:]
    assert float(dstate.denom.max()) > 0
