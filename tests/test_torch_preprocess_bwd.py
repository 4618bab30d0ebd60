"""The render op's preprocess (``ops/kernels/preprocess.py``) on the CPU:
its closed-form backward against autograd of the composite
(``ops/projection.py::preprocess``) in float64, and against ``jax.vjp`` of
the JAX package's ``preprocess`` in float32, on the same numpy inputs.

Every case has Gaussians past the field-of-view clamp, behind the near
plane and below ``alpha_min``, the view matrix requiring a gradient, and a
random cotangent on every column of the feature table.  The cases cover SH
degrees 0-3, ``cov3D_precomp``, ``colors_precomp``,
``normalize_quaternions``, ``opacity_cull`` x ``bin_margin_px``, the light,
full and no pose branches, a zero-determinant Gaussian and the ``means2D``
offset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.ops.projection import (
    preprocess as jax_preprocess)
from diff_gaussian_rasterization_tpu_torch.camera import Camera, look_at
from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.ops import projection
from diff_gaussian_rasterization_tpu_torch.ops.kernels import preprocess as kp

torch.set_num_threads(2)

P, H, W = 96, 32, 40
BASE = dict(tile_h=8, tile_w=8)
CASES = {
    "sh0": dict(sh=0, m2d=False),
    "sh1": dict(sh=1),
    "sh2": dict(sh=2),
    "sh3": dict(sh=3),
    "cov3D_precomp": dict(sh=1, cov=True),
    "colors_precomp": dict(col=True),
    "normalize_quaternions": dict(sh=2, cfg=dict(normalize_quaternions=True)),
    "cull_off": dict(sh=1, cfg=dict(opacity_cull=False)),
    "cull_margin": dict(sh=1, cfg=dict(bin_margin_px=2.5)),
    "cull_off_margin": dict(sh=1, cfg=dict(opacity_cull=False,
                                           bin_margin_px=2.5)),
    "full": dict(sh=3, cfg=dict(pose_cov2d_branch=True,
                                pose_sh_branch=True)),
    "full_colors": dict(col=True, cfg=dict(pose_cov2d_branch=True,
                                           pose_sh_branch=True)),
    "no_pose": dict(sh=1, cfg=dict(pose_ndc_branch=False,
                                   pose_depth_branch=False)),
    "zero_det": dict(sh=1, zero_det=True, cfg=dict(lowpass=0.0)),
}


def make_case(name, seed=0):
    """numpy inputs (float64) of a case, its config fields and camera."""
    spec = CASES[name]
    rng = np.random.RandomState(seed)
    means = rng.uniform(-1.0, 1.0, (P, 3))
    means[:, 2] = rng.uniform(1.0, 4.0, P)
    means[:8, :2] *= 6.0             # past the field-of-view clamp
    means[8:12, 2] = rng.uniform(-1.5, -0.5, 4)  # behind the near plane
    quats = rng.normal(size=(P, 4))
    quats *= rng.uniform(0.7, 1.3, (P, 1)) / np.linalg.norm(
        quats, axis=1, keepdims=True)
    inp = dict(means3D=means,
               opacities=rng.uniform(0.02, 0.95, (P, 1)),
               scales=rng.uniform(0.05, 0.25, (P, 3)), rotations=quats)
    if spec.get("zero_det"):
        inp["scales"][20] = 0.0      # Sigma = 0 and no low-pass: det = 0
    if spec.get("cov"):
        s = torch.as_tensor(inp.pop("scales"))
        q = torch.as_tensor(inp.pop("rotations"))
        inp["cov3D_precomp"] = projection.compute_cov3d(s, q, 1.0).numpy()
    if spec.get("col"):
        inp["colors_precomp"] = rng.uniform(0.0, 1.0, (P, 3))
    else:
        deg = spec["sh"]
        # one extra coefficient row beyond the degree's: its gradient is 0
        inp["shs"] = rng.normal(scale=0.4, size=(P, (deg + 1) ** 2 + 1, 3))
    if spec.get("m2d", True):
        inp["means2D"] = rng.normal(scale=0.01, size=(P, 2))
    view = look_at((0.2, -0.1, -0.3), (0.1, 0.05, 3.0), dtype=torch.float64,
                   device="cpu").numpy()
    fields = {**BASE, **spec.get("cfg", {})}
    static = dict(tanfovx=float(np.tan(0.5)), tanfovy=float(np.tan(0.4)),
                  height=H, width=W)
    d_feat = rng.normal(size=(P, 11))
    return inp, view, fields, static, spec.get("sh", 0), d_feat


def torch_leaves(inp, view, dtype):
    leaves = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
              for k, v in inp.items()}
    leaves["view"] = torch.tensor(view, dtype=dtype, requires_grad=True)
    return leaves


def call(fn, leaves, fields, static, deg):
    kw = {k: v for k, v in leaves.items() if k not in ("means3D", "view")}
    if "shs" in kw:
        kw["sh_degree"] = deg
    cam = Camera(viewmatrix=leaves["view"], **static)
    return fn(leaves["means3D"], cam, RasterConfig(**fields), **kw)


def grads(out, leaves, d_feat):
    """{leaf: gradient}, None where none reached it or it needs none."""
    live = {k: x for k, x in leaves.items() if x.requires_grad}
    g = torch.autograd.grad(out, list(live.values()), d_feat,
                            allow_unused=True)
    g = dict(zip(live, g))
    return {k: (None if g.get(k) is None else g[k].detach().numpy())
            for k in leaves}


def composite_feat(*args, **kw):
    return kp.feature_table(projection.preprocess(*args, **kw))


def op_feat(*args, **kw):
    return kp.preprocess_table(*args, **kw)[1]


@pytest.mark.parametrize("name", list(CASES))
def test_closed_form_matches_autograd_float64(name):
    """The Function (forward the composite, backward the closed form) gives
    the composite's outputs and autograd's gradient of every leaf, the view
    matrix's included, to float64 rounding."""
    inp, view, fields, static, deg, d_feat = make_case(name)
    f64 = torch.float64
    la, lb = torch_leaves(inp, view, f64), torch_leaves(inp, view, f64)
    d = torch.as_tensor(d_feat, dtype=f64)
    feat_a = call(composite_feat, la, fields, static, deg)
    prep_b, feat_b = call(kp.preprocess_table, lb, fields, static, deg)
    assert torch.equal(feat_a, feat_b)
    prep_a = call(projection.preprocess, la, fields, static, deg)
    for k in ("mask", "radius", "rect_min", "rect_max", "tiles_touched"):
        assert torch.equal(getattr(prep_a, k), getattr(prep_b, k)), k
    assert not bool(prep_b.mask[8:12].any())     # behind the near plane
    ga, gb = grads(feat_a, la, d), grads(feat_b, lb, d)
    for k in la:
        if ga[k] is None:
            assert gb[k] is None or not np.any(gb[k]), k
            continue
        scale = max(float(np.abs(ga[k]).max()), 1e-30)
        np.testing.assert_allclose(gb[k], ga[k], rtol=1e-9,
                                   atol=1e-11 * scale, err_msg=k)
        assert np.isfinite(gb[k]).all(), k
    if name == "no_pose":
        assert not np.any(gb["view"])
    else:
        assert np.abs(gb["view"]).max() > 0
    if name == "zero_det":
        assert not bool(prep_b.mask[20])
        np.testing.assert_array_equal(feat_b[20, 2:5].detach().numpy(), 0.0)


def jax_vjp(inp, view, fields, static, deg, d_feat):
    """``jax.vjp`` of the JAX package's preprocess, its feature table as
    the output, at the float32 inputs."""
    names = list(inp) + ["view"]
    primals = [jnp.asarray(inp[k], jnp.float32) for k in inp]
    primals.append(jnp.asarray(view, jnp.float32))
    cfg = JaxConfig(**fields)

    def f(*xs):
        args = dict(zip(names, xs))
        cam = JaxCamera(viewmatrix=args.pop("view"), **static)
        means = args.pop("means3D")
        if "shs" in args:
            args["sh_degree"] = deg
        p = jax_preprocess(means, cam, cfg, **args)
        return jnp.concatenate(
            [p.xy, p.conic, p.opacity[:, None], p.color, p.depth[:, None],
             p.depth_sgview[:, None]], 1)

    _, vjp = jax.vjp(f, *primals)
    g = vjp(jnp.asarray(d_feat, jnp.float32))
    return {k: np.asarray(x) for k, x in zip(names, g)}


@pytest.mark.parametrize("name", list(CASES))
def test_closed_form_matches_jax_vjp(name):
    """The closed form in float32 against the JAX package's autodiff:
    each leaf within 2e-4 of its largest entry (the two sum the view
    matrix's gradient over P in other orders, and the conic's in other
    roundings)."""
    inp, view, fields, static, deg, d_feat = make_case(name, seed=1)
    lb = torch_leaves(inp, view, torch.float32)
    feat = call(op_feat, lb, fields, static, deg)
    gb = grads(feat, lb, torch.as_tensor(d_feat, dtype=torch.float32))
    gj = jax_vjp(inp, view, fields, static, deg, d_feat)
    for k, want in gj.items():
        got = gb[k] if gb[k] is not None else np.zeros_like(want)
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale,
                                   err_msg=k)


def test_means2d_gradient_and_culled_slots():
    """``means2D``'s gradient is the NDC scale of the centres' cotangent;
    the slots the mask culls (behind the near plane, past the footprint)
    get finite gradients in every leaf."""
    inp, view, fields, static, deg, d_feat = make_case("sh2", seed=2)
    leaves = torch_leaves(inp, view, torch.float32)
    prep, feat = call(kp.preprocess_table, leaves, fields, static, deg)
    g = grads(feat, leaves, torch.as_tensor(d_feat, dtype=torch.float32))
    want = d_feat[:, :2] * 0.5 * np.array([W, H])
    np.testing.assert_allclose(g["means2D"], want, rtol=1e-6)
    culled = ~prep.mask.numpy()
    assert culled[8:12].all() and culled.sum() >= 4
    for k, x in g.items():
        assert np.isfinite(x).all(), k


@pytest.mark.parametrize("which", ["view_only", "gaussians_only",
                                   "depth_copy"])
def test_view_gradient_gating(which):
    """The view path runs only when the view needs a gradient (the Adam
    tracker: Gaussians detached; the map step: the view detached), and the
    depth copy in column 10 never reaches the view matrix."""
    inp, view, fields, static, deg, d_feat = make_case("full", seed=3)
    f64 = torch.float64
    la, lb = torch_leaves(inp, view, f64), torch_leaves(inp, view, f64)
    d = torch.as_tensor(d_feat, dtype=f64)
    if which == "depth_copy":
        d = torch.zeros_like(d)
        d[:, 10] = 1.0
    for leaves in (la, lb):
        for k, x in leaves.items():
            x.requires_grad_(which == "depth_copy" or (
                (k == "view") == (which == "view_only")))
    ga = grads(call(composite_feat, la, fields, static, deg), la, d)
    gb = grads(call(op_feat, lb, fields, static, deg), lb, d)
    for k in la:
        if not la[k].requires_grad:
            assert gb[k] is None, k
            continue
        np.testing.assert_allclose(gb[k], ga[k], rtol=1e-9, atol=1e-12,
                                   err_msg=k)
    if which == "depth_copy":
        assert not np.any(gb["view"])
        assert np.abs(gb["means3D"]).max() > 0
