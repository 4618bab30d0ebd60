"""The plain versions of ``ops/kernels/gauss_newton.py`` on the CPU.

- ``twist_tangents_reference`` (the twist basis in closed form) against
  ``torch.func.jacfwd`` of ``lie.apply_twist`` and the JAX package's
  ``jax.jacfwd`` of its ``lie.apply_twist``, in float32 and float64, at
  xi = 0, inside the Taylor branch of ``_rot_coeffs`` (|w|^2 ~ 1e-13), at
  |w| = 1e-3 and at 0.5 rad.  float64: 1e-12 of the largest entry (the
  closed form and forward mode round apart); float32 against float32: the
  lie tests' rtol 1e-5 / atol 1e-6.
- ``gn_reduce_reference`` and ``lm_update_reference`` against the
  tracker's Gauss-Newton evaluation and its two LM loops as they were
  written in ``models/slam.py`` (kept below as the spec): bit for bit.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.models import lie as jlie
from diff_gaussian_rasterization_tpu.utils.testing import enable_x64
from diff_gaussian_rasterization_tpu_torch.models import lie
from diff_gaussian_rasterization_tpu_torch.ops.kernels import gauss_newton as gn

torch.set_num_threads(2)

# |w| of the four points: zero, inside the Taylor branch (|w|^2 ~ 1e-13),
# a small angle, half a radian
ANGLES = [0.0, math.sqrt(1e-13), 1e-3, 0.5]


def view(dtype):
    v = torch.eye(4, dtype=torch.float64)
    v[:3, :3] = lie.exp_so3(torch.tensor([0.3, -0.5, 0.2],
                                         dtype=torch.float64)).T
    v[3, :3] = torch.tensor([0.1, -0.2, 1.5], dtype=torch.float64)
    return v.to(dtype)


def twist(angle, dtype):
    rng = np.random.RandomState(5)
    xi = rng.normal(size=6)
    xi[:3] *= 0.05
    xi[3:] *= angle / np.linalg.norm(xi[3:])
    return torch.tensor(xi, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("angle", ANGLES)
def test_twist_tangents_reference_matches_jacfwd_and_jax(angle, dtype):
    v0, xi = view(dtype), twist(angle, dtype)
    got_view, got = gn.twist_tangents_reference(v0, xi)
    assert got.shape == (6, 4, 4) and got.dtype == dtype
    assert torch.equal(got_view, lie.apply_twist(v0, xi))
    assert torch.equal(gn.twist_tangents_reference(v0, xi, False)[0],
                       got_view)
    want = torch.func.jacfwd(lambda x: lie.apply_twist(v0, x))(xi)
    want = want.movedim(-1, 0)
    with (enable_x64() if dtype == torch.float64
          else contextlib.nullcontext()):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        j = jax.jacfwd(lambda x: jlie.apply_twist(jnp.asarray(
            v0.numpy(), jdt), x))(jnp.asarray(xi.numpy(), jdt))
        from_jax = np.moveaxis(np.asarray(j), -1, 0)
    assert from_jax.dtype == got.numpy().dtype
    if dtype == torch.float64:
        tol = 1e-12 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
        np.testing.assert_allclose(got.numpy(), from_jax, rtol=0, atol=tol)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), from_jax, rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------------------------
# the tracker's formulas as models/slam.py wrote them: the spec
# --------------------------------------------------------------------------


def spec_huber_cost(r, huber):
    w = 1.0 / torch.sqrt(1.0 + (r / huber) ** 2)
    return 0.5 * (w * r * r).sum(), w


def spec_lm_solve(h, g, lam):
    eye = torch.eye(6, dtype=h.dtype, device=h.device)
    a = h + lam * torch.diag(torch.diag(h)) + 1e-9 * eye
    return torch.linalg.solve_ex(a, -g)[0]


def spec_lm_damping(accept, lam):
    return torch.where(accept, torch.clamp_min(lam / 3.0, 1e-7),
                       torch.clamp_max(lam * 5.0, 1e3))


def spec_gn_eval(color, depth, sil, rgb, gt_depth, tans, thr, sqc, sqd,
                 huber):
    """``_track_gn``'s ``gn_eval`` after the dual render."""
    m = ((sil > thr) & (gt_depth > 0)).to(rgb.dtype)
    rc = ((color - rgb) * m[None]).reshape(-1)
    depth_est = depth / torch.clamp_min(sil, 1e-6)
    rd = ((depth_est - gt_depth) * m).reshape(-1)
    r = torch.cat([sqc * rc, sqd * rd])
    cost, w = spec_huber_cost(r, huber)
    if tans is None:
        return None, None, cost
    dcolor, ddepth, dsil_t = tans
    silc = torch.clamp_min(sil, 1e-6)
    dsil = torch.where(sil > 1e-6, dsil_t, torch.zeros_like(dsil_t))
    jc = (dcolor * m[None, None]).reshape(6, -1)
    jd = ((ddepth * silc[None] - depth[None] * dsil)
          / (silc * silc)[None] * m[None]).reshape(6, -1)
    jac = torch.cat([sqc * jc, sqd * jd], 1)
    jw = jac * w[None, :]
    return jw @ jac.T, jw @ r, cost


def images(h, w, seed, dtype=torch.float32):
    """A render, its six tangent images and a target: a quarter of the
    silhouette below 0.99, a tenth of the target depth invalid, some
    silhouette at 0 (the clamp) and at 1e-6 (dsil zeroed)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g, dtype=dtype)
    sil = torch.where(r(h, w) < 0.25, r(h, w), 0.99 + 0.01 * r(h, w))
    sil[0, :4] = 0.0
    sil[1, :4] = 1e-6
    depth = (1.0 + 2.0 * r(h, w)) * sil
    gt_depth = torch.where(r(h, w) < 0.1, torch.zeros(h, w, dtype=dtype),
                           1.0 + 2.0 * r(h, w))
    tans = (r(6, 3, h, w) - 0.5, 3.0 * (r(6, h, w) - 0.5),
            0.1 * (r(6, h, w) - 0.5))
    return (r(3, h, w), depth, sil, r(3, h, w), gt_depth), tans


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("size,thr,w_depth", [((24, 40), 0.99, 0.25),
                                             ((17, 23), 0.85, 1.5)])
def test_gn_reduce_reference_is_the_tracker_formula(full, size, thr,
                                                    w_depth):
    ims, tans = images(*size, seed=size[0])
    sqc, sqd = 1.0, math.sqrt(w_depth)
    kw = dict(sil_threshold=thr, sqc=sqc, sqd=sqd, huber=0.05)
    got = gn.gn_reduce_reference(*ims, tangents=tans if full else None,
                                 **kw)
    want = spec_gn_eval(*ims, tans if full else None, thr, sqc, sqd, 0.05)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def normal_equations(seed, n, singular_at=None):
    """``n`` evaluations' (h, g, cost): SPD h, one with a NaN entry at
    ``singular_at`` (its step is not finite), costs that fall, rise and
    repeat."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for i in range(n):
        a = torch.randn(6, 6, generator=g)
        h = a @ a.T + 0.1 * torch.eye(6)
        if i == singular_at:
            h[2, 3] = float("nan")
        cost = torch.tensor([5.0, 4.0, 4.5, 4.0, 3.0, 3.5, 3.5][i % 7])
        out.append((h, torch.randn(6, generator=g), cost))
    return out


@pytest.mark.parametrize("singular_at", [None, 1, 2])
def test_lm_update_reference_is_the_deferred_loop(singular_at):
    evals = normal_equations(3, 7, singular_at)
    zero, inf = torch.zeros(6), torch.tensor(math.inf)
    lam = torch.tensor(1e-4)
    best_xi, best_cost, costs = zero, inf, []
    anchor, dx, cost_anchor, trials = zero, zero, inf, []
    accepts = []
    for h, g, cost in evals:
        xi_try = anchor + dx
        trials.append(xi_try)
        better = cost < best_cost
        best_xi = torch.where(better, xi_try, best_xi)
        best_cost = torch.where(better, cost, best_cost)
        accept = cost < cost_anchor
        accepts.append(bool(accept))
        lam = spec_lm_damping(accept, lam)
        dx_new = spec_lm_solve(h, g, lam)
        ok = torch.isfinite(dx_new).all()
        dx = torch.where(accept & ok, dx_new, 0.5 * dx)
        anchor = torch.where(accept, xi_try, anchor)
        cost_anchor = torch.where(accept, cost, cost_anchor)
        costs.append(cost)

    st = gn.LmState.start(1e-4, len(evals), zero)
    for i, (h, g, cost) in enumerate(evals):
        assert torch.equal(st.xi, trials[i])
        gn.lm_update_reference(h, g, cost, st, gn.DEFERRED, i)
        assert bool(st.accepted) == accepts[i]
    assert torch.equal(st.best_xi, best_xi)
    assert torch.equal(st.best_cost, best_cost)
    assert torch.equal(st.costs, torch.stack(costs))
    assert torch.equal(st.vec[gn.LAM], lam)
    assert torch.equal(st.vec[gn.DX:gn.DX + 6], dx)
    assert False in accepts and True in accepts


@pytest.mark.parametrize("singular_at", [None, 1])
def test_lm_update_reference_is_the_line_search_loop(singular_at):
    evals = normal_equations(4, 6, singular_at)
    trial_costs = [torch.tensor(c) for c in (4.9, 4.2, 3.0, 3.9, 4.0, 3.2)]
    final_cost = torch.tensor(3.05)
    zero, inf = torch.zeros(6), torch.tensor(math.inf)
    lam = torch.tensor(1e-4)
    xi, best_xi, best_cost, costs, accepts = zero, zero, inf, [], []
    for (h, g, cost), c2 in zip(evals, trial_costs):
        better = cost < best_cost
        best_xi = torch.where(better, xi, best_xi)
        best_cost = torch.where(better, cost, best_cost)
        dx = spec_lm_solve(h, g, lam)
        xi2 = xi + dx
        accept = (c2 < cost) & torch.isfinite(dx).all()
        accepts.append(bool(accept))
        xi = torch.where(accept, xi2, xi)
        lam = spec_lm_damping(accept, lam)
        costs.append(cost)
    better = final_cost < best_cost
    want_xi = torch.where(better, xi, best_xi)
    want_cost = torch.where(better, final_cost, best_cost)

    st = gn.LmState.start(1e-4, len(evals), zero)
    for i, ((h, g, cost), c2) in enumerate(zip(evals, trial_costs)):
        gn.lm_update_reference(h, g, cost, st, gn.PROPOSE, i)
        gn.lm_update_reference(None, None, c2, st, gn.DECIDE, 0)
        assert bool(st.accepted) == accepts[i]
    gn.lm_update_reference(None, None, final_cost, st, gn.FINAL, 0)
    assert torch.equal(st.xi, xi)
    assert torch.equal(st.best_xi, want_xi)
    assert torch.equal(st.best_cost, want_cost)
    assert torch.equal(st.costs, torch.stack(costs))
    assert torch.equal(st.vec[gn.LAM], lam)
    assert False in accepts and True in accepts
