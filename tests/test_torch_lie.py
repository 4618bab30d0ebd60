"""The port's SE(3) utilities against the JAX package's ``models/lie.py``,
on the CPU, in float32: every function on seeded inputs at rtol 1e-5 /
atol 1e-6 (float32 rounding of a few operations), ``_rot_coeffs`` on both
sides of its small-angle switch, ``quat_from_rotmat`` at each of its four
pivots, and the twist basis ``jacfwd(apply_twist)`` at zero and away from
it against ``jax.jacfwd``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.models import lie as jlie
from diff_gaussian_rasterization_tpu_torch.models import lie

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **{**TOL, **kw})


def view(seed=0):
    """A rigid row-convention view matrix."""
    rng = np.random.RandomState(seed)
    r = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(size=3) * 0.7,
                                            jnp.float32)))
    v = np.eye(4, dtype=np.float32)
    v[:3, :3] = r.T
    v[3, :3] = rng.normal(size=3)
    return v


def test_hat_and_quat_mul_match_jax():
    rng = np.random.RandomState(1)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    close(lie.hat(torch.as_tensor(w)), jlie.hat(jnp.asarray(w)))
    a, b = (rng.normal(size=(7, 4)).astype(np.float32) for _ in range(2))
    close(lie.quat_mul(torch.as_tensor(a), torch.as_tensor(b)),
          jlie.quat_mul(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 0.3, 2.5])
def test_rot_coeffs_and_exp_match_jax(scale):
    """Scales 0 and 1e-7 take the small-angle polynomials (|w|^2 < 1e-12)."""
    rng = np.random.RandomState(2)
    xi = (rng.normal(size=6) * scale).astype(np.float32)
    t, j = torch.as_tensor(xi), jnp.asarray(xi)
    for a, b in zip(lie._rot_coeffs(t[3:]), jlie._rot_coeffs(j[3:])):
        close(a, b)
    close(lie.exp_so3(t[3:]), jlie.exp_so3(j[3:]))
    close(lie.exp_se3(t), jlie.exp_se3(j))
    v = view(3)
    close(lie.apply_twist(torch.as_tensor(v), t),
          jlie.apply_twist(jnp.asarray(v), j))


@pytest.mark.parametrize("at_zero", [True, False])
def test_twist_basis_jacfwd_matches_jax(at_zero):
    """The twist basis tracking uses, [4, 4, 6]; finite at xi = 0."""
    v = view(4)
    xi = np.zeros(6, np.float32) if at_zero else \
        np.random.RandomState(5).normal(size=6).astype(np.float32) * 0.05
    a = torch.func.jacfwd(lambda x: lie.apply_twist(torch.as_tensor(v), x))(
        torch.as_tensor(xi))
    b = jax.jacfwd(lambda x: jlie.apply_twist(jnp.asarray(v), x))(
        jnp.asarray(xi))
    assert tuple(a.shape) == (4, 4, 6)
    assert bool(torch.isfinite(a).all())
    close(a, b)


def rotation_with_pivot(pivot):
    """A rotation whose largest Shepperd pivot (trace, m00, m11, m22) is
    ``pivot``: the identity for the trace, else a rotation by ~170 degrees
    about that axis."""
    if pivot == 0:
        w = np.array([0.1, -0.2, 0.15])
    else:
        w = np.zeros(3)
        w[pivot - 1] = 2.97
        w += np.array([0.05, -0.04, 0.03])
    return np.array(jlie.exp_so3(jnp.asarray(w, jnp.float32)))


@pytest.mark.parametrize("pivot", [0, 1, 2, 3])
def test_quat_from_rotmat_pivots_match_jax(pivot):
    m = rotation_with_pivot(pivot)
    d = np.diag(m)
    assert int(np.argmax([d.sum(), *d])) == pivot
    close(lie.quat_from_rotmat(torch.as_tensor(m)),
          jlie.quat_from_rotmat(jnp.asarray(m)))
    batch = np.stack([rotation_with_pivot(k) for k in range(4)])
    close(lie.quat_from_rotmat(torch.as_tensor(batch)),
          jlie.quat_from_rotmat(jnp.asarray(batch)))


def test_orthonormalize_view_matches_jax():
    v = view(6)
    v[:3, :3] += np.random.RandomState(7).normal(
        scale=0.01, size=(3, 3)).astype(np.float32)
    a = lie.orthonormalize_view(torch.as_tensor(v))
    close(a, jlie.orthonormalize_view(jnp.asarray(v)), atol=2e-6)
    r = a[:3, :3].numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
