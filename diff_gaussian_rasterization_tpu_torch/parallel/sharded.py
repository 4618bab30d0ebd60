"""Multi-device rendering, mapping and pose-graph refinement over a
``torch.distributed`` device mesh (PyTorch port of the JAX package's
``parallel/sharded.py``).

SPMD, as ``parallel/mesh.py`` says: every rank calls with the same
replicated inputs and gets back the global result.  Each function is a
per-rank body (plain tensors, with ``rank`` and ``n`` as arguments) and
the collectives around it, so that the bodies can be held one by one
against the JAX package's ``shard_map`` in one process.

1. **Tile-sharded rendering** (``core_fwd_sharded``, ``core_bwd_sharded``,
   ``core_fwd_jvp_sharded``; ``rasterize(mesh=)`` runs them inside its
   autograd function).  The instance table is replicated; the tile grid
   is padded to a multiple of the axis and each rank renders its
   contiguous run of tiles (the kernels' ``tile0``), and the tile-major
   outputs are all-gathered.  Each instance belongs to one tile, so the
   per-instance ``u_inst`` / ``npix_inst`` and the backward's gradient rows
   [I, 12] are all-reduced *before* ``segment_sum_rows``: every element
   adds one nonzero term to zeros, and the sharded render and all its
   gradients are bit-equal to the unsharded ones.

2. **Keyframe data parallelism** (``sharded_value_and_grad``): each rank
   differentiates the loss of its keyframes; the gradients, the loss and
   the weights are all-reduced.

3. **Gaussian-map sharding** (``gather_visible``): each rank frustum-tests
   its rows of the (replicated) map, compacts the visible ones into a
   fixed budget and all-gathers them.  The gather's backward takes this
   rank's slice of the cotangent (``mesh.AllGather``), so each rank's
   gradient is nonzero on its own rows only, and one all-reduce over the
   map axis adds each row's one nonzero term to zeros.
   ``scatter_gathered_stats`` routes per-Gaussian statistics of the
   gathered set back to their rows.  ``sharded_kf_map_value_and_grad``
   composes 2 and 3 in one step.

4. **Edge-sharded pose-graph refinement** (``refine_poses_sharded``):
   each rank builds the normal equations of its edges and one all-reduce
   sums them; the solve runs replicated, in float32 on the CPU.

Padding follows the JAX package: tiles to a multiple of the axis, keyframe
windows with weight-0 copies (``models/slam.py``), pose-graph edges with
identity measurements and weight 0.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..models import lie
from ..ops.kernels.render import (CoreOutputs, PoseTangents, core_bwd,
                                  core_fwd, core_fwd_jvp)
from .mesh import (all_gather, all_gather_grad, all_reduce, axis_group,
                   comm_device)

# --------------------------------------------------------------------------
# 1. tile-sharded rendering
# --------------------------------------------------------------------------


class TileShard(NamedTuple):
    """A rank's share of a tile-sharded render: the axis's group, this
    rank's index along it and the axis's size."""

    group: object
    rank: int
    n: int


def tile_shard(mesh, axis: str) -> TileShard:
    return TileShard(*axis_group(mesh, axis))


def tile_share(n_tiles: int, n: int, rank: int):
    """``(tile0, count)``: the run of tiles rank ``rank`` of ``n`` renders,
    the grid padded to a multiple of ``n`` (its tiles past ``n_tiles`` have
    no instances and no pixels in the image)."""
    count = -(-n_tiles // n)
    return rank * count, count


def local_tiles(x, tile0: int, count: int):
    """Rows ``tile0 .. tile0 + count - 1`` of a tile-major array, zeros past
    its end (the padded grid's empty tiles)."""
    part = x[tile0:tile0 + count]
    pad = count - part.shape[0]
    if pad <= 0:
        return part.contiguous()
    return torch.cat([part, part.new_zeros((pad,) + tuple(x.shape[1:]))], 0)


def core_fwd_local(table, tile_start, tile_stop, gt_tiles, rank: int, n: int,
                   **core_kw) -> CoreOutputs:
    """Rank ``rank``'s body of the tile-sharded forward: its tiles'
    tile-major outputs, and ``u_inst`` / ``npix_inst`` [I] over its tiles
    (zeros for every other tile's instances)."""
    tile0, count = tile_share(tile_start.shape[0], n, rank)
    ts, tp, gt = (local_tiles(x, tile0, count)
                  for x in (tile_start, tile_stop, gt_tiles))
    return core_fwd(table, ts, tp, gt, tile0=tile0, **core_kw)


def gather_tiles(x, shard: TileShard, n_tiles: int):
    """The global tile-major array from every rank's share."""
    return all_gather(x, shard.group, shard.n)[:n_tiles]


def core_fwd_sharded(table, tile_start, tile_stop, gt_tiles,
                     shard: TileShard, **core_kw):
    """The tile-sharded forward: ``(global CoreOutputs, this rank's local
    CoreOutputs)``; the local outputs are what the backward needs."""
    local = core_fwd_local(table, tile_start, tile_stop, gt_tiles,
                           shard.rank, shard.n, **core_kw)
    t = tile_start.shape[0]
    glob = CoreOutputs(
        *(gather_tiles(x, shard, t) for x in local[:9]),
        all_reduce(local.u_inst, shard.group),
        all_reduce(local.npix_inst, shard.group))
    return glob, local


def core_bwd_local(table, tile_start, tile_stop, gt_tiles, totals, cots,
                   rank: int, n: int, *, n_contrib, **core_kw):
    """Rank ``rank``'s body of the tile-sharded backward: the gradient rows
    [I, 12] of its tiles' instances (zeros elsewhere).  ``totals`` and
    ``n_contrib`` are this rank's forward outputs, ``cots`` the global
    cotangents."""
    tile0, count = tile_share(tile_start.shape[0], n, rank)
    ts, tp, gt = (local_tiles(x, tile0, count)
                  for x in (tile_start, tile_stop, gt_tiles))
    cots = tuple(local_tiles(c, tile0, count) for c in cots)
    return core_bwd(table, ts, tp, gt, totals, cots, n_contrib=n_contrib,
                    tile0=tile0, **core_kw)


def core_bwd_sharded(table, tile_start, tile_stop, gt_tiles, totals, cots,
                     shard: TileShard, *, n_contrib, **core_kw):
    """The tile-sharded backward: the global gradient rows [I, 12], each
    the one rank's row that is not zero (so bit-equal to the unsharded
    rows)."""
    rows = core_bwd_local(table, tile_start, tile_stop, gt_tiles, totals,
                          cots, shard.rank, shard.n, n_contrib=n_contrib,
                          **core_kw)
    return all_reduce(rows, shard.group)


def core_fwd_jvp_local(table, tans, tile_start, tile_stop, gt_tiles,
                       rank: int, n: int, **core_kw):
    """Rank ``rank``'s body of the tile-sharded dual render: its tiles'
    (CoreOutputs, PoseTangents)."""
    tile0, count = tile_share(tile_start.shape[0], n, rank)
    ts, tp, gt = (local_tiles(x, tile0, count)
                  for x in (tile_start, tile_stop, gt_tiles))
    return core_fwd_jvp(table, tans, ts, tp, gt, tile0=tile0, **core_kw)


def core_fwd_jvp_sharded(table, tans, tile_start, tile_stop, gt_tiles,
                         shard: TileShard, **core_kw):
    """The tile-sharded dual render: the global (CoreOutputs,
    PoseTangents), bit-equal to the unsharded ones.  ``rasterize_with_
    pose_jvp`` takes it for the light variant only, as the JAX package
    does."""
    out, tano = core_fwd_jvp_local(table, tans, tile_start, tile_stop,
                                   gt_tiles, shard.rank, shard.n, **core_kw)
    t = tile_start.shape[0]
    out = CoreOutputs(*(gather_tiles(x, shard, t) for x in out[:9]),
                      all_reduce(out.u_inst, shard.group),
                      all_reduce(out.npix_inst, shard.group))
    return out, PoseTangents(*(gather_tiles(x, shard, t) for x in tano))


# --------------------------------------------------------------------------
# 3. Gaussian-map sharding
# --------------------------------------------------------------------------


def gather_visible_local(params: dict, viewmatrix, rank: int, n: int, *,
                         budget_per_shard: int, near: float = 0.2):
    """Rank ``rank``'s body of :func:`gather_visible`: its rows of the
    replicated ``params``, those in front of the near plane compacted
    first in a stable order, cut to the budget.  Returns ``(picked,
    valid [budget] bool, over-budget flag, order [budget] int64)``; the
    ``order`` indices are local to the rank's rows."""
    p = params["means3D"].shape[0]
    if p % n:
        raise ValueError(f"the map's {p} rows do not split over {n} ranks")
    p_loc = p // n
    if budget_per_shard > p_loc:
        raise ValueError(f"budget_per_shard {budget_per_shard} exceeds the "
                         f"{p_loc} rows of a shard")
    rows = slice(rank * p_loc, (rank + 1) * p_loc)
    means = params["means3D"][rows]
    z = means.detach() @ viewmatrix[:3, 2] + viewmatrix[3, 2]
    vis = z > near
    count = vis.sum()
    order = torch.sort((~vis).to(torch.int8), stable=True).indices[
        :budget_per_shard]
    valid = (torch.arange(budget_per_shard, device=means.device)
             < torch.clamp_max(count, budget_per_shard))
    picked = {k: v[rows][order] for k, v in params.items()}
    return picked, valid, count > budget_per_shard, order


def gather_visible(params: dict, viewmatrix, mesh, axis: str = "map", *,
                   budget_per_shard: int, near: float = 0.2,
                   with_order: bool = False):
    """Frustum-cull a map sharded over ``axis`` and all-gather the visible
    subset.

    ``params`` is a dict of per-Gaussian tensors with leading dim P (P a
    multiple of the axis size), replicated; rank r owns rows
    ``[r P/n, (r+1) P/n)``.  Each rank compacts its visible Gaussians
    (``params["means3D"]`` in front of ``near``) in a stable order into
    ``budget_per_shard`` slots, and the slots of every rank are gathered.
    Returns ``(gathered, valid, overflow)``: tensors of leading dim
    ``n * budget_per_shard``, their validity mask (render with
    ``opacities * valid`` so padding renders as nothing) and an int32 flag,
    1 when any shard was over its budget (never a silent cap).  Gradients
    of the gathered tensors return to each rank's own rows only (the
    caller all-reduces them over ``axis``).  ``with_order=True`` also
    returns every rank's compaction order [n * budget_per_shard], the
    handle of :func:`scatter_gathered_stats`.
    """
    group, rank, n = axis_group(mesh, axis)
    picked, valid, over, order = gather_visible_local(
        params, viewmatrix, rank, n, budget_per_shard=budget_per_shard,
        near=near)
    gathered = {k: all_gather_grad(v, group, rank, n)
                for k, v in picked.items()}
    valid_g = all_gather(valid, group, n)
    overflow = all_reduce(over.to(torch.int32), group,
                          op=torch.distributed.ReduceOp.MAX)
    if with_order:
        return gathered, valid_g, overflow, all_gather(order, group, n)
    return gathered, valid_g, overflow


def scatter_gathered_local(stats, order, valid_g, rank: int, n: int,
                           p_global: int):
    """Rank ``rank``'s body of :func:`scatter_gathered_stats`: its slice of
    the gathered rows, padding zeroed, written at its compaction order
    into its block [P/n, k] (the order's indices are distinct, so this is
    a plain scatter)."""
    budget = order.shape[0] // n
    sl = slice(rank * budget, (rank + 1) * budget)
    st = stats.detach()[sl]
    st = torch.where(valid_g[sl][:, None], st, torch.zeros_like(st))
    block = st.new_zeros((p_global // n,) + tuple(st.shape[1:]))
    block[order[sl]] = st
    return block


def scatter_gathered_stats(stats, order, valid_g, mesh, axis: str = "map",
                           *, p_global: int):
    """Route per-Gaussian statistics [n * budget, k] of a gathered working
    set (e.g. ``RenderOutputs.gau_uncertainty``) back to the map's rows:
    the inverse of :func:`gather_visible`'s compaction.  ``order`` and
    ``valid_g`` are ``gather_visible(with_order=True)``'s.  Returns the
    global [P, k] (no gradient), zeros on rows that were not gathered."""
    group, rank, n = axis_group(mesh, axis)
    return all_gather(scatter_gathered_local(stats, order, valid_g, rank, n,
                                             p_global), group, n)


# --------------------------------------------------------------------------
# 2. keyframe data parallelism
# --------------------------------------------------------------------------


def _frames_of(k: int, n: int, rank: int) -> slice:
    if k % n:
        raise ValueError(f"{k} keyframes do not split over {n} ranks: pad "
                         f"the window with weight-0 frames")
    m = k // n
    return slice(rank * m, (rank + 1) * m)


def _tree_add(a, b):
    return b if a is None else tuple(x + y for x, y in zip(a, b))


def kf_value_and_grad_local(loss_one_frame: Callable, params: dict, views,
                            rgbs, depths, extra, rank: int, n: int,
                            has_aux: bool = False):
    """Rank ``rank``'s body of :func:`sharded_value_and_grad`: over its
    keyframes, ``(sum of losses, {name: gradient}, summed aux)``; the
    gradients are with respect to detached copies of ``params``."""
    fr = _frames_of(views.shape[0], n, rank)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, aux = 0.0, None
    with torch.enable_grad():
        for i in range(fr.start, fr.stop):
            out = loss_one_frame(leaves, views[i], rgbs[i], depths[i],
                                 *(e[i] for e in extra))
            if has_aux:
                out, a = out
                aux = _tree_add(aux, tuple(x.detach() for x in a))
            total = total + out
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return total.detach(), grads, aux


def sharded_value_and_grad(loss_one_frame: Callable, mesh, axis: str = "kf",
                           has_aux: bool = False, n_extra: int = 0,
                           weighted: bool = False):
    """Data-parallel value and gradient over a keyframe batch sharded over
    ``axis``.

    ``loss_one_frame(params, view, rgb, depth, *extra) -> scalar`` (or
    ``(scalar, aux)`` with ``has_aux``, aux a tuple of additive
    per-Gaussian statistics, summed over frames and ranks).  Returns
    ``f(params, views, rgbs, depths, *extra) -> (loss, grads[, aux])``:
    the batch (K a multiple of the axis size) and the ``n_extra`` trailing
    per-frame tensors are split over the ranks; the mean loss and the
    gradients (a dict like ``params``) are all-reduced.  ``weighted=True``
    takes ``extra[0]`` as per-frame weights and divides by their global
    sum instead of K, so that a window padded with weight-0 frames keeps
    its objective.
    """
    group, rank, n = axis_group(mesh, axis)

    def f(params, views, rgbs, depths, *extra):
        if len(extra) != n_extra:
            raise ValueError(f"expected {n_extra} extra per-frame tensors, "
                             f"got {len(extra)}")
        total, grads, aux = kf_value_and_grad_local(
            loss_one_frame, params, views, rgbs, depths, extra, rank, n,
            has_aux)
        if weighted:   # replicated weights: their sum is the global one
            denom = torch.clamp_min(extra[0].sum(), 1e-9)
        else:
            denom = float(views.shape[0])
        loss = all_reduce(total, group) / denom
        grads = {k: all_reduce(g, group) / denom for k, g in grads.items()}
        if has_aux:
            return loss, grads, tuple(all_reduce(a, group) for a in aux)
        return loss, grads

    return f


def sharded_kf_map_value_and_grad(loss_one_frame: Callable, mesh,
                                  kf_axis: str = "kf",
                                  map_axis: str = "map", *,
                                  budget_per_shard: int,
                                  near: float = 0.2, n_extra: int = 1,
                                  gau_stats: bool = False):
    """Keyframe x Gaussian-map sharding composed in one mapping step.

    The keyframe batch ``(views, rgbs, depths, *extra)`` is split over
    ``kf_axis``; for each of its frames a rank gathers the visible subset
    of its map row (:func:`gather_visible` over ``map_axis``) and computes
    ``loss_one_frame(gathered, valid, view, rgb, depth, *extra_i)``, which
    every rank of the map row computes alike.  ``params`` (a dict of
    per-Gaussian tensors) and ``consts`` (non-differentiable ones such as
    the ``active`` mask, gathered alongside) are replicated.  The
    gradients are all-reduced over ``kf_axis`` (the frames) and then over
    ``map_axis`` (each row has one nonzero term); ``extra[0]`` are the
    per-frame weights, and the loss divides by their global sum.

    Returns ``f(params, consts, views, rgbs, depths, *extra) -> (loss,
    grads, overflow)``; with ``gau_stats``, ``loss_one_frame`` returns
    ``(scalar, stats)`` with stats a tuple of [n_map * budget, k] arrays
    on the gathered set, routed back to the map's rows, summed over frames
    and returned as a fourth element, a tuple of global [P, k].
    """
    kf_group, kf_rank, nk = axis_group(mesh, kf_axis)
    map_group, map_rank, nm = axis_group(mesh, map_axis)

    def f(params, consts, views, rgbs, depths, *extra):
        if len(extra) != n_extra:
            raise ValueError(f"expected {n_extra} extra per-frame tensors, "
                             f"got {len(extra)}")
        fr = _frames_of(views.shape[0], nk, kf_rank)
        p_global = params["means3D"].shape[0]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        total, stats = 0.0, None
        ovf = torch.zeros((), dtype=torch.int32, device=views.device)
        with torch.enable_grad():
            for i in range(fr.start, fr.stop):
                g, valid, o, order = gather_visible(
                    {**leaves, **consts}, views[i], mesh, map_axis,
                    budget_per_shard=budget_per_shard, near=near,
                    with_order=True)
                out = loss_one_frame(g, valid, views[i], rgbs[i], depths[i],
                                     *(e[i] for e in extra))
                if gau_stats:
                    out, st = out
                    routed = tuple(scatter_gathered_local(
                        s, order, valid, map_rank, nm, p_global) for s in st)
                    stats = _tree_add(stats, routed)
                total = total + out
                ovf = torch.maximum(ovf, o.to(ovf.device))
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        # the weights are replicated: their sum is the global one
        denom = torch.clamp_min(extra[0].sum(), 1e-9)
        loss = all_reduce(total.detach(), kf_group) / denom
        out_grads = {}
        for (k, v), gr in zip(leaves.items(), grads):
            gr = torch.zeros_like(v) if gr is None else gr
            gr = all_reduce(all_reduce(gr, kf_group), map_group)
            out_grads[k] = gr / denom
        overflow = all_reduce(all_reduce(ovf, kf_group,
                                         torch.distributed.ReduceOp.MAX),
                              map_group, torch.distributed.ReduceOp.MAX)
        if gau_stats:
            stats = tuple(all_gather(all_reduce(s, kf_group), map_group, nm)
                          for s in stats)
            return loss, out_grads, overflow, stats
        return loss, out_grads, overflow

    return f


# --------------------------------------------------------------------------
# 4. distributed pose-graph refinement
# --------------------------------------------------------------------------


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


def edge_shards(edges, zs, weights, n: int):
    """The edges padded to a multiple of ``n`` (edge (0, 0), an identity
    measurement and weight 0, which adds nothing) and split in ``n``
    contiguous shards: a list of ``(edges, zs, weights)``."""
    e = edges.shape[0]
    pad = -e % n
    if pad:
        edges = torch.cat([edges, edges.new_zeros((pad, 2))])
        zs = torch.cat([zs, torch.eye(4, dtype=zs.dtype).repeat(pad, 1, 1)])
        weights = torch.cat([weights, weights.new_zeros(pad)])
    m = edges.shape[0] // n
    return [(edges[r * m:(r + 1) * m], zs[r * m:(r + 1) * m],
             weights[r * m:(r + 1) * m]) for r in range(n)]


def normal_equations(views, edges, zs, weights):
    """The weighted normal equations ``(H [6K, 6K], b [6K])`` of a set of
    edges, each edge's chordal residual relinearized at the current poses
    (its [6, 12] Jacobian in the two poses' twists by
    ``torch.func.jacfwd``)."""
    k = views.shape[0]
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
    r, jac = lin(views[ei], views[ej], zs)                  # [E,6], [E,6,12]
    jt = jac.transpose(1, 2)
    h_e = weights[:, None, None] * (jt @ jac)                # [E, 12, 12]
    b_e = weights[:, None] * (jt @ r[..., None])[..., 0]     # [E, 12]
    h = torch.zeros(6 * k, 6 * k)
    h.index_put_((idx[:, :, None].expand(-1, -1, 12),
                  idx[:, None, :].expand(-1, 12, -1)), h_e, accumulate=True)
    b = torch.zeros(6 * k).index_put_((idx,), b_e, accumulate=True)
    return h, b


def gn_update(views, h, b, prior: float):
    """One damped Gauss-Newton step of every pose from the summed normal
    equations: ``prior`` on pose 0's block (the gauge), 1e-6 on the
    diagonal, the solve, the twist applied and the rotations projected
    onto SO(3)."""
    k = views.shape[0]
    six = torch.arange(6)
    h = h.clone()
    h[six, six] += prior
    h = h + 1e-6 * torch.eye(6 * k)
    dx = torch.linalg.solve(h, -b).reshape(k, 6)
    return torch.stack([lie.orthonormalize_view(lie.apply_twist(v, d))
                        for v, d in zip(views, dx)])


def refine_poses_sharded(views, edges, zs, mesh=None, axis: str = "kf",
                         iters: int = 5, weights=None, prior: float = 1e6):
    """Gauss-Newton pose-graph refinement in float32 on the CPU, with
    edge-sharded normal equations over ``axis`` of ``mesh``.

    Each iteration sums the weighted normal equations H = J^T J,
    b = J^T r of every edge (:func:`normal_equations`; with a mesh, each
    rank those of its edge shard and one all-reduce the rest) and takes
    one :func:`gn_update`.  ``mesh=None`` runs the same math on one
    device.

    Args:
      views: [K, 4, 4] row-convention w2c poses.
      edges: [E, 2] (i, j) pairs.
      zs:    [E, 4, 4] measured relative transforms X_j X_i^-1.
      weights: optional [E] edge weights.
    Returns [K, 4, 4] refined poses, a float32 CPU tensor.
    """
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cpu")
    views, zs = f32(views), f32(zs)
    edges = torch.as_tensor(edges, dtype=torch.int64, device="cpu")
    weights = torch.ones(edges.shape[0]) if weights is None else f32(weights)
    if mesh is None:
        shard = (edges, zs, weights)
    else:
        group, rank, n = axis_group(mesh, axis)
        shard = edge_shards(edges, zs, weights, n)[rank]
        dev = comm_device(mesh)
    for _ in range(iters):
        h, b = normal_equations(views, *shard)
        if mesh is not None:
            h = all_reduce(h.to(dev), group).cpu()
            b = all_reduce(b.to(dev), group).cpu()
        views = gn_update(views, h, b, prior)
    return views
