"""The port's mapping step against the JAX package's, on the CPU.

``rgbd_loss`` in both modes, the learning-rate schedule of
``make_map_optimizer`` against optax's, ``DensifyState``, and one and two
``map_step``s on a small model over a two-keyframe window against the JAX
package's ``map_step``: the loss and the gradients at the gradient
tolerance of ``test_rasterize.py`` (rtol 5e-4 / atol 2e-5), the densify
statistics, and the parameters after each step within a tenth of each
field's learning rate (Adam's first steps move an entry by about
lr * sign(g), so entries whose gradient is below 1e-6 are left out).
The map-sharded step on a one-rank gloo mesh updates the model bit for
bit as the one-device step does; a map axis without a mesh is refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.models import slam as jslam
from diff_gaussian_rasterization_tpu.models.gaussians import (
    DensifyState as JaxDensifyState, GaussianModel as JaxModel)
from diff_gaussian_rasterization_tpu_torch.convert import (
    gaussian_model_from_numpy)
from diff_gaussian_rasterization_tpu_torch.models import slam
from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
    PARAM_FIELDS, DensifyState)
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import make_mesh

from test_torch_rasterize import CFG, port_config
from torch_dist_cases import one_rank_world

torch.set_num_threads(2)

H, W, TANX, TANY = 24, 32, 0.55, 0.42
MCFG = dict(lr_decay=0.5, lr_decay_steps=2, lr_decay_floor=0.8)


class Out:
    """The fields of a render that ``rgbd_loss`` reads."""

    def __init__(self, color, depth, opacity_map):
        self.color, self.depth, self.opacity_map = color, depth, opacity_map


@pytest.mark.parametrize("tracking", [False, True])
def test_rgbd_loss_matches_jax(tracking):
    rng = np.random.RandomState(0)
    color = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    depth = rng.uniform(0.5, 4, (1, H, W)).astype(np.float32)
    sil = rng.uniform(0.3, 1.0, (1, H, W)).astype(np.float32)
    rgb = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    gt_d = np.where(rng.uniform(size=(H, W)) < 0.1, 0.0,
                    rng.uniform(1, 4, (H, W))).astype(np.float32)

    def jloss(c, d, s):
        frame = jslam.Frame(jnp.asarray(rgb), jnp.asarray(gt_d))
        return jslam.rgbd_loss(Out(c, d, s), frame, sil_threshold=0.8,
                               tracking=tracking)
    j = jnp.asarray
    lj, gj = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        j(color), j(depth), j(sil))
    t = [torch.as_tensor(x).requires_grad_() for x in (color, depth, sil)]
    lt = slam.rgbd_loss(Out(*t), slam.Frame(torch.as_tensor(rgb),
                                            torch.as_tensor(gt_d)),
                        sil_threshold=0.8, tracking=tracking)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    for a, b in zip(gj, t):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-9)


def test_map_optimizer_schedule_matches_optax():
    """Geometry groups decay continuously to the floor, like optax's
    ``exponential_decay(..., end_value=)``; the others keep their rate."""
    mcfg = slam.MappingConfig(lr_decay=0.3, lr_decay_steps=3,
                              lr_decay_floor=0.2)
    model = gaussian_model_from_numpy(small_model(8), device="cpu")
    opt = slam.make_map_optimizer(model, mcfg)
    lrs = {"means3D": mcfg.lr_means, "scales_log": mcfg.lr_scales,
           "rotations": mcfg.lr_rotations}
    for step in range(8):
        for group, name in zip(opt.adam.param_groups, PARAM_FIELDS):
            assert group["name"] == name
            if name in slam.GEOMETRY_FIELDS:
                want = float(optax.exponential_decay(
                    init_value=lrs[name], transition_steps=3, decay_rate=0.3,
                    end_value=lrs[name] * 0.2)(step))
                np.testing.assert_allclose(group["lr"], want, rtol=1e-6)
            else:
                assert group["lr"] == group["initial_lr"]
        opt.step()
    assert slam.make_map_optimizer(model, slam.MappingConfig()).schedule \
        is None


def test_densify_state_matches_jax():
    rng = np.random.RandomState(5)
    g2d = rng.normal(size=(10, 2)).astype(np.float32)
    vis = rng.uniform(size=10) < 0.6
    a = JaxDensifyState.zero(10).update(jnp.asarray(g2d), jnp.asarray(vis))
    a = a.update(jnp.asarray(g2d), jnp.asarray(~vis))
    b = DensifyState.zero(10, device="cpu").update(torch.as_tensor(g2d),
                                                   torch.as_tensor(vis))
    b = b.update(torch.as_tensor(g2d), torch.as_tensor(~vis))
    np.testing.assert_allclose(b.grad_accum.numpy(), np.asarray(a.grad_accum),
                               rtol=1e-6)
    np.testing.assert_array_equal(b.denom.numpy(), np.asarray(a.denom))


def small_model(p=64, seed=0):
    """Numpy fields of a small SH-1 model, a few slots inactive."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-1, 1, (p, 3))
    means[:, 2] = rng.uniform(1.5, 4, p)
    quats = rng.normal(size=(p, 4))
    sh = rng.normal(scale=0.3, size=(p, 4, 3))
    sh[:, 0] += 1.0
    f = lambda x: np.asarray(x, np.float32)
    return dict(means3D=f(means),
                scales_log=f(np.log(rng.uniform(0.05, 0.25, (p, 3)))),
                rotations=f(quats / np.linalg.norm(quats, axis=1,
                                                   keepdims=True)),
                opacities_logit=f(rng.normal(size=(p, 1))), sh=f(sh),
                active=np.arange(p) % 9 != 4)


def window(seed=1):
    """Two keyframes: views, targets and weights."""
    rng = np.random.RandomState(seed)
    a = 0.05
    v2 = np.eye(4)
    v2[:3, :3] = [[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                  [np.sin(a), 0, np.cos(a)]]
    v2[3, :3] = [0.05, -0.02, 0.03]
    views = np.stack([np.eye(4), v2]).astype(np.float32)
    rgbs = rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    depths = np.where(rng.uniform(size=(2, H, W)) < 0.1, 0.0,
                      rng.uniform(1, 4, (2, H, W))).astype(np.float32)
    wts = np.asarray([1.0, 0.5], np.float32)
    return views, rgbs, depths, wts


def jax_loss_grads(fields, views, rgbs, depths, wts, cfg, mcfg):
    """map_step's loss and its gradients, through the JAX package's own
    render_model and rgbd_loss."""
    model = JaxModel(**{k: jnp.asarray(v) for k, v in fields.items()})

    def loss_fn(params):
        m = model.replace(**params)
        total = 0.0
        for i in range(2):
            cam = JaxCamera(viewmatrix=jnp.asarray(views[i]), tanfovx=TANX,
                            tanfovy=TANY, height=H, width=W)
            out = jslam.render_model(m, cam, cfg, gt_depth=depths[i],
                                     means2D=jnp.zeros((m.capacity, 2)),
                                     track_off=True)
            total = total + wts[i] * jslam.rgbd_loss(
                out, jslam.Frame(rgbs[i], depths[i]), mcfg.w_color,
                mcfg.w_depth)
        return total / wts.sum()
    return jax.value_and_grad(loss_fn)(jslam.model_params(model))


def test_map_step_matches_jax():
    cfg = CFG.replace(instance_multiplier=12)
    mcfg_j = jslam.MappingConfig(**MCFG)
    mcfg_t = slam.MappingConfig(**{
        f.name: getattr(mcfg_j, f.name)
        for f in dataclasses.fields(slam.MappingConfig)})
    fields = small_model()
    views, rgbs, depths, wts = window()
    j = jnp.asarray

    # JAX: two map steps
    jm = JaxModel(**{k: j(v) for k, v in fields.items()})
    opt_state = jslam.make_map_optimizer(mcfg_j).init(jslam.model_params(jm))
    jd = JaxDensifyState.zero(jm.capacity)
    jaxs = []
    for _ in range(2):
        jm, opt_state, jd, jl, (ju, jn) = jslam.map_step(
            jm, opt_state, jd, j(views), j(rgbs), j(depths), j(wts), cfg,
            mcfg_j, H, W, TANX, TANY, 2)
        jaxs.append((jm, jd, float(jl), np.asarray(ju), np.asarray(jn)))
    l0, g0 = jax_loss_grads(fields, views, rgbs, depths, wts, cfg, mcfg_j)

    # the port
    tm = gaussian_model_from_numpy(fields, device="cpu")
    opt = slam.make_map_optimizer(tm, mcfg_t)
    td = DensifyState.zero(tm.means3D.shape[0], device="cpu")
    t = torch.as_tensor
    for step in range(2):
        loss, td, (tu, tn) = slam.map_step(
            tm, opt, td, t(views), t(rgbs), t(depths), t(wts),
            port_config(cfg), mcfg_t, H, W, TANX, TANY, 2)
        jm, jd, jl, ju, jn = jaxs[step]
        np.testing.assert_allclose(float(loss), jl, rtol=1e-4)
        if step == 0:
            np.testing.assert_allclose(float(loss), float(l0), rtol=1e-5)
            for k in PARAM_FIELDS:
                np.testing.assert_allclose(
                    getattr(tm, k).grad.numpy(), np.asarray(g0[k]),
                    rtol=5e-4, atol=2e-5, err_msg=k)
                assert float(np.abs(np.asarray(g0[k])).max()) > 0, k
        np.testing.assert_array_equal(td.denom.numpy(), np.asarray(jd.denom))
        np.testing.assert_allclose(td.grad_accum.numpy(),
                                   np.asarray(jd.grad_accum), rtol=5e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(tu.numpy(), ju, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(tn.numpy(), jn)
        for k, group in zip(PARAM_FIELDS, opt.adam.param_groups):
            lr = group["initial_lr"] if "initial_lr" in group else group["lr"]
            live = np.abs(np.asarray(g0[k])) >= 1e-6
            a = getattr(tm, k).detach().numpy()[live]
            b = np.asarray(getattr(jm, k))[live]
            assert np.abs(a - b).max() <= lr / 10, (step, k)
    assert float(td.denom.max()) > 0
    # the meshed step: a map axis needs a mesh; on a one-rank mesh the
    # map-sharded step (the visible subset gathered, the gradients routed
    # back to the map's rows) updates the model bit for bit as the
    # one-device step does
    with pytest.raises(ValueError):
        slam.map_step(tm, opt, td, t(views), t(rgbs), t(depths), t(wts),
                      port_config(cfg), mcfg_t, H, W, TANX, TANY, 2,
                      map_axis="map")
    models = []
    with one_rank_world():
        mesh = make_mesh((1, 1), ("kf", "map"), backend="gloo",
                         device="cpu")
        for kw in ({}, dict(mesh=mesh, map_axis="map")):
            m = gaussian_model_from_numpy(fields, device="cpu")
            loss, _, _ = slam.map_step(
                m, slam.make_map_optimizer(m, mcfg_t),
                DensifyState.zero(m.capacity, device="cpu"), t(views),
                t(rgbs), t(depths), t(wts), port_config(cfg), mcfg_t, H, W,
                TANX, TANY, 2, **kw)
            models.append((float(loss), m))
    assert models[0][0] == models[1][0]
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(models[0][1], k),
                           getattr(models[1][1], k)), k


def jax_bench_make_model():
    """``bench_tracking.make_model`` of the JAX package, run alone: the
    module itself sets up a compile cache when imported."""
    import ast
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "bench_tracking.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_model")
    ns = dict(np=np, jnp=jnp, GaussianModel=JaxModel, P=100_000)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"),
         ns)
    return ns["make_model"]


def test_mapping_model_matches_bench_tracking():
    """``scenes.mapping_model`` draws the JAX mapping benchmark's model
    (``bench_tracking.make_model``) bit for bit."""
    from diff_gaussian_rasterization_tpu_torch.scenes import mapping_model
    a = jax_bench_make_model()(seed=3, p=500)
    b = mapping_model(seed=3, p=500, device="cpu")
    for f in PARAM_FIELDS + ("active",):
        np.testing.assert_array_equal(getattr(b, f).detach().numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
