"""Pose-graph refinement with the normal equations (PyTorch port of the
JAX package's ``parallel/sharded.py`` section 4, for one device).

``refine_poses_sharded`` is the solver the SLAM runner's
``refine_keyframes`` calls: Gauss-Newton on the chordal SE(3) residuals of
the graph's edges, pose 0 held by a large prior.  The edge-sharded version
over a mesh (the normal equations summed over devices) is not ported:
``mesh`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..models import lie


def _se3_chordal_residual(xi_i, xi_j, view_i, view_j, z):
    """One edge's SE(3) residual [6] at the twists ``xi_i``, ``xi_j`` of its
    two poses.

    With the relative error E = Z^-1 (X_j X_i^-1) (row-convention
    matrices), the residual stacks the skew part of E's rotation and its
    translation row: zero iff E = I, and smooth.
    """
    xi_mat = lie.apply_twist(view_i, xi_i)
    xj_mat = lie.apply_twist(view_j, xi_j)
    e = torch.linalg.inv(z) @ (xj_mat @ torch.linalg.inv(xi_mat))
    r = e[:3, :3]
    skew = 0.5 * (r - r.T)
    return torch.cat([torch.stack([skew[2, 1], skew[0, 2], skew[1, 0]]),
                      e[3, :3]])


def refine_poses_sharded(views, edges, zs, mesh=None, axis: str = "kf",
                         iters: int = 5, weights=None, prior: float = 1e6):
    """Gauss-Newton pose-graph refinement in float32 on the CPU.

    Each iteration relinearizes every edge's chordal residual at the
    current poses (its [6, 12] Jacobian in the two poses' twists by
    ``torch.func.jacfwd``), sums the weighted normal equations
    H = J^T J, b = J^T r into the 6K x 6K system, adds ``prior`` on pose
    0's block (the gauge) and 1e-6 on the diagonal, solves, and applies
    the step to every pose (then projects the rotations onto SO(3)).

    Args:
      views: [K, 4, 4] row-convention w2c poses.
      edges: [E, 2] (i, j) pairs.
      zs:    [E, 4, 4] measured relative transforms X_j X_i^-1.
      weights: optional [E] edge weights.
    Returns [K, 4, 4] refined poses, a float32 CPU tensor.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the edge-sharded pose-graph solver is not ported: "
            "refine_poses_sharded runs with mesh=None")
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cpu")
    views, zs = f32(views), f32(zs)
    edges = torch.as_tensor(edges, dtype=torch.int64, device="cpu")
    k, e = views.shape[0], edges.shape[0]
    weights = torch.ones(e) if weights is None else f32(weights)
    ei, ej = edges[:, 0], edges[:, 1]
    # each edge's twist indices in the 6K unknowns: pose i's, then pose j's
    six = torch.arange(6)
    idx = torch.cat([ei[:, None] * 6 + six, ej[:, None] * 6 + six], 1)

    def res(xi12, view_i, view_j, z):
        return _se3_chordal_residual(xi12[:6], xi12[6:], view_i, view_j, z)

    lin = torch.func.vmap(
        lambda vi, vj, z: (res(torch.zeros(12), vi, vj, z),
                           torch.func.jacfwd(res)(torch.zeros(12), vi, vj,
                                                  z)))
    for _ in range(iters):
        r, jac = lin(views[ei], views[ej], zs)               # [E,6], [E,6,12]
        jt = jac.transpose(1, 2)
        h_e = weights[:, None, None] * (jt @ jac)            # [E, 12, 12]
        b_e = weights[:, None] * (jt @ r[..., None])[..., 0]  # [E, 12]
        h = torch.zeros(6 * k, 6 * k)
        h.index_put_((idx[:, :, None].expand(-1, -1, 12),
                      idx[:, None, :].expand(-1, 12, -1)), h_e,
                     accumulate=True)
        b = torch.zeros(6 * k).index_put_((idx,), b_e, accumulate=True)
        h[six, six] += prior
        h = h + 1e-6 * torch.eye(6 * k)
        dx = torch.linalg.solve(h, -b).reshape(k, 6)
        views = torch.stack([lie.orthonormalize_view(lie.apply_twist(v, d))
                             for v, d in zip(views, dx)])
    return views
