"""Tracking's Gauss-Newton step outside the dual render: the twist basis,
the normal equations and the Levenberg-Marquardt update.

- :func:`twist_tangents`: the view ``V0 exp(xi)^T`` (``lie.apply_twist``)
  and its derivatives along the six twist directions [6, 4, 4], the
  ``view_tangents`` of ``rasterize_with_pose_jvp``; view only with
  ``tangents=False``.
- :func:`gn_reduce`: from a render's images, its six tangent images and
  the target, the tracking mask, the colour and depth residuals, their
  Jacobian, the Huber IRLS weights and the sums ``H = J^T W J`` [6, 6],
  ``g = J^T W r`` [6] and the cost ``0.5 r^T W r``; cost only without
  tangents.  With ``lm=(state, mode, slot)`` it then runs one stage of the
  LM update on an :class:`LmState`: ``DEFERRED`` (the deferred-accept
  step), ``PROPOSE`` / ``DECIDE`` / ``FINAL`` (the line search's proposal,
  its decision from the trial's cost, the final comparison).

On CUDA tensors (float32) the kernels of ``csrc/gauss_newton.cu``: one
launch each, no host wait, the sums in double in a fixed order (two calls
give the same bits), the LM stage in the reduction's last block with its
6 x 6 solve in double.  On CPU tensors (any float dtype) the plain
versions: the twist tangents in closed form in torch
(:func:`twist_tangents_reference`), and the tracker's formulas as they
were written in torch (:func:`gn_reduce_reference`,
:func:`lm_update_reference`).  These wrappers alone choose between them,
from the tensors' device.  ``launches`` counts the kernels' launches, only
where they launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ...models import lie
from .render import _check_cuda

# the state vector of the LM update (csrc/gauss_newton.cu kXi ... kLam):
# the current point, the deferred accept's anchor, the pending step, the
# best point, the line search's trial point (6 each), the reference cost
# (the anchor's, or the line search's cost at xi), the best cost, the
# damping
XI, ANCHOR, DX, BEST_XI, TRIAL = 0, 6, 12, 18, 24
REF_COST, BEST_COST, LAM = 30, 31, 32
STATE = 33
# LM stages (csrc/gauss_newton.cu kNone ... kFinal)
NONE, DEFERRED, PROPOSE, DECIDE, FINAL = -1, 0, 1, 2, 3

MAX_BLOCKS = 264  # gn_reduce's blocks at most (kMaxBlocks)
SUMS = 28         # H's upper triangle, g, the cost (kFull)

launches = {"twist_tangents": 0, "gn_reduce": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


class LmState(NamedTuple):
    """The LM update's state on the tracker's device: ``vec`` [STATE] (the
    offsets above), the cost of every iteration ``costs`` [iters], and the
    last accept decision ``accept`` [1] (bool)."""

    vec: torch.Tensor
    costs: torch.Tensor
    accept: torch.Tensor

    @staticmethod
    def start(lam0: float, iters: int, like) -> "LmState":
        """Zero steps, infinite costs, damping ``lam0``; ``like`` gives the
        dtype and device (fills only: no host copy)."""
        vec = like.new_zeros(STATE)
        vec[REF_COST:LAM].fill_(math.inf)
        vec[LAM].fill_(lam0)
        return LmState(vec, like.new_empty(iters),
                       torch.zeros(1, dtype=torch.bool, device=like.device))

    @property
    def xi(self):
        return self.vec[XI:XI + 6]

    @property
    def trial(self):
        return self.vec[TRIAL:TRIAL + 6]

    @property
    def best_xi(self):
        return self.vec[BEST_XI:BEST_XI + 6]

    @property
    def best_cost(self):
        return self.vec[BEST_COST]

    @property
    def accepted(self):
        return self.accept[0]


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------


def twist_tangents_reference(view0, xi, tangents: bool = True):
    """Plain version of :func:`twist_tangents`: ``lie.apply_twist(view0,
    xi)`` and, in closed form in the inputs' dtype, its derivatives along
    (v, w): ``V0 dE_k^T`` with ``dE`` from the derivatives of
    ``lie._rot_coeffs`` by ``t2 = |w|^2`` (its Taylor branch below 1e-12
    differentiated as the polynomials it is)."""
    view = lie.apply_twist(view0, xi)
    if not tangents:
        return view, None
    v, w = xi[:3], xi[3:]
    a, b, c = lie._rot_coeffs(w)
    t2 = (w * w).sum()
    small = t2 < 1e-12
    t2s = torch.where(small, torch.ones_like(t2), t2)
    cs = torch.cos(torch.sqrt(t2s))
    full = lambda x: torch.full_like(t2, x)
    da = torch.where(small, full(-1.0 / 6.0), (cs - a) / (2.0 * t2s))
    db = torch.where(small, full(-1.0 / 24.0), (0.5 * a - b) / t2s)
    dc = torch.where(small, full(-1.0 / 120.0), (b - 3.0 * c) / (2.0 * t2s))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    k = lie.hat(w)
    k2 = k @ k
    vm = eye + b * k + c * k2
    dk = lie.hat(eye)                    # [3, 3, 3]: hat(e_d)
    dk2 = dk @ k + k @ dk
    dt2 = (2.0 * w)[:, None, None]
    drot = da * dt2 * k + a * dk + db * dt2 * k2 + b * dk2
    dvm = db * dt2 * k + b * dk + dc * dt2 * k2 + c * dk2
    zeros = torch.zeros((3, 3, 3), dtype=xi.dtype, device=xi.device)
    top = torch.cat([torch.cat([zeros, vm.T[:, :, None]], 2),      # along v
                     torch.cat([drot, (dvm @ v)[:, :, None]], 2)])  # along w
    de = torch.cat([top, torch.zeros((6, 1, 4), dtype=xi.dtype,
                                     device=xi.device)], 1)
    return view, view0 @ de.transpose(-1, -2)


def huber_cost(r, huber: float):
    """0.5 sum w r^2 with the Huber IRLS weights w, and w."""
    w = 1.0 / torch.sqrt(1.0 + (r / huber) ** 2)
    return 0.5 * (w * r * r).sum(), w


def lm_solve(h, g, lam):
    """The damped normal equations' step; ``solve_ex`` does not wait on
    the host to check the factorization (a failed one gives non-finite
    entries, which the callers test)."""
    eye = torch.eye(6, dtype=h.dtype, device=h.device)
    a = h + lam * torch.diag(torch.diag(h)) + 1e-9 * eye
    return torch.linalg.solve_ex(a, -g)[0]


def lm_damping(accept, lam):
    return torch.where(accept, torch.clamp_min(lam / 3.0, 1e-7),
                       torch.clamp_max(lam * 5.0, 1e3))


def tracking_mask(sil, gt_depth, sil_threshold: float, dtype):
    """The pixels the tracker fits: silhouette above ``sil_threshold`` and
    a valid target depth, as 0 / 1 of ``dtype``."""
    return ((sil > sil_threshold) & (gt_depth > 0)).to(dtype)


def residuals(color, depth, sil, rgb, gt_depth, m, sqc: float, sqd: float):
    """The colour residuals and the depth residuals (the accumulated depth
    over the silhouette clamped at 1e-6), masked by ``m`` and weighted by
    ``sqc`` and ``sqd``, flat: [4 H W]."""
    rc = ((color - rgb) * m[None]).reshape(-1)
    depth_est = depth / torch.clamp_min(sil, 1e-6)
    rd = ((depth_est - gt_depth) * m).reshape(-1)
    return torch.cat([sqc * rc, sqd * rd])


def gn_reduce_reference(color, depth, sil, rgb, gt_depth, *,
                        sil_threshold: float, sqc: float, sqd: float,
                        huber: float, tangents=None, lm=None):
    """Plain version of :func:`gn_reduce`: the residuals, the Jacobian
    [6, 4 H W] (the depth's by the quotient rule, ``dsil`` zeroed where the
    silhouette is at most 1e-6), the Huber weights and the products, in
    torch in the inputs' dtype; then :func:`lm_update_reference`."""
    m = tracking_mask(sil, gt_depth, sil_threshold, rgb.dtype)
    r = residuals(color, depth, sil, rgb, gt_depth, m, sqc, sqd)
    cost, w = huber_cost(r, huber)
    h = g = None
    if tangents is not None:
        dcolor, ddepth, dsil = tangents
        silc = torch.clamp_min(sil, 1e-6)
        dsil = torch.where(sil > 1e-6, dsil, torch.zeros_like(dsil))
        jc = (dcolor * m[None, None]).reshape(6, -1)
        jd = ((ddepth * silc[None] - depth[None] * dsil)
              / (silc * silc)[None] * m[None]).reshape(6, -1)
        jac = torch.cat([sqc * jc, sqd * jd], 1)                # [6, N]
        jw = jac * w[None, :]
        h, g = jw @ jac.T, jw @ r
    if lm is not None:
        lm_update_reference(h, g, cost, *lm)
    return h, g, cost


def lm_update_reference(h, g, cost, state: LmState, mode: int, slot: int):
    """Plain version of the LM stage: one step of the tracker's
    bookkeeping on ``state``, in place.

    ``DEFERRED`` (at the trial ``xi = anchor + dx``): a trial below the
    anchor's cost is accepted (the damping / 3, floored at 1e-7, and the
    next step solved); a rejected one keeps the anchor and halves the step
    (the damping x 5, capped at 1e3); a non-finite step counts as
    rejected; then ``xi = anchor + dx``.  ``PROPOSE`` (at ``xi``): the step
    and the trial ``xi + dx``.  ``DECIDE`` (given the trial's cost): accept
    when it is below the cost at ``xi`` and the step is finite.  ``FINAL``
    (given the cost at ``xi``): the best point.  ``DEFERRED``, ``PROPOSE``
    and ``FINAL`` track the best point, the first two write ``costs[slot]``.
    """
    v = state.vec
    xi, anchor, dx, best_xi, trial = (v[o:o + 6] for o in
                                      (XI, ANCHOR, DX, BEST_XI, TRIAL))
    ref_cost, best_cost, lam = v[REF_COST], v[BEST_COST], v[LAM]
    accept = None
    if mode in (DEFERRED, PROPOSE, FINAL):
        better = cost < best_cost
        best_xi = torch.where(better, xi, best_xi)
        best_cost = torch.where(better, cost, best_cost)
    if mode in (DEFERRED, PROPOSE):
        state.costs[slot] = cost
    if mode == DEFERRED:
        accept = cost < ref_cost
        lam = lm_damping(accept, lam)
        dx_new = lm_solve(h, g, lam)
        ok = torch.isfinite(dx_new).all()
        dx = torch.where(accept & ok, dx_new, 0.5 * dx)
        anchor = torch.where(accept, xi, anchor)
        ref_cost = torch.where(accept, cost, ref_cost)
        xi = anchor + dx
    elif mode == PROPOSE:
        dx = lm_solve(h, g, lam)
        trial = xi + dx
        ref_cost = cost
    elif mode == DECIDE:
        accept = (cost < ref_cost) & torch.isfinite(dx).all()
        xi = torch.where(accept, trial, xi)
        lam = lm_damping(accept, lam)
    v.copy_(torch.cat([xi, anchor, dx, best_xi, trial,
                       torch.stack([ref_cost, best_cost, lam])]))
    if accept is not None:
        state.accept.copy_(accept.reshape(1))


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def twist_tangents(view0, xi, tangents: bool = True):
    """``(view [4, 4], tangents [6, 4, 4] or None)``: ``V0 exp(xi)^T`` and
    its derivatives along the twist directions (v, w), for
    ``rasterize_with_pose_jvp``.  On CUDA tensors (float32) the
    ``twist_tangents`` kernel (one thread, double inside), on CPU tensors
    :func:`twist_tangents_reference`."""
    if view0.device.type == "cpu":
        return twist_tangents_reference(view0, xi, tangents)
    from ._build import load
    v0, x = view0.detach().contiguous(), xi.detach().contiguous()
    _check_cuda(v0, torch.float32, "view0")
    _check_cuda(x, torch.float32, "xi")
    if v0.shape != (4, 4) or x.shape != (6,) or x.device != v0.device:
        raise ValueError(f"view0 must be [4, 4] and xi [6] on one device, "
                         f"got {tuple(v0.shape)}, {tuple(x.shape)}")
    view = torch.empty((4, 4), dtype=torch.float32, device=v0.device)
    tan = (torch.empty((6, 4, 4), dtype=torch.float32, device=v0.device)
           if tangents else None)
    with torch.cuda.device(v0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("gauss_newton").twist_tangents(
            v0.data_ptr(), x.data_ptr(), view.data_ptr(), _ptr(tan), stream)
    if rc != 0:
        raise RuntimeError(f"twist_tangents launch failed: CUDA error {rc}")
    launches["twist_tangents"] += 1
    return view, tan


# gn_reduce's per-block partial sums and its ticket (zero between calls:
# the kernel's last block resets it), one pair a device and stream, so
# that calls on one stream run in order
_scratch: dict = {}


def _scratch_of(dev):
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    got = _scratch.get(key)
    if got is None:
        got = _scratch[key] = (
            torch.empty(MAX_BLOCKS * SUMS, dtype=torch.float64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    return got


def gn_reduce(color, depth, sil, rgb, gt_depth, *, sil_threshold: float,
              sqc: float, sqd: float, huber: float, tangents=None, lm=None):
    """The tracker's normal equations from one render: ``(h [6, 6], g [6],
    cost [])``, ``h`` and ``g`` None without ``tangents`` (cost only).

    ``color`` [3, H, W], ``depth`` and ``sil`` [H, W] are the render's,
    ``rgb`` [3, H, W] and ``gt_depth`` [H, W] the target's; ``tangents``
    ``(dcolor [6, 3, H, W], ddepth [6, H, W], dsil [6, H, W])`` the dual
    render's.  ``lm=(state, mode, slot)`` then applies that LM stage to
    ``state`` (:func:`lm_update_reference`).  On CUDA tensors (float32; any
    strides with a contiguous last axis) the ``gn_reduce`` kernel, the LM
    stage in its last block; on CPU tensors :func:`gn_reduce_reference`.
    """
    kw = dict(sil_threshold=sil_threshold, sqc=sqc, sqd=sqd, huber=huber)
    if color.device.type == "cpu":
        return gn_reduce_reference(color, depth, sil, rgb, gt_depth,
                                   tangents=tangents, lm=lm, **kw)
    from ._build import load
    hgt, wid = sil.shape[-2:]
    shapes = [(3, hgt, wid), (hgt, wid), (hgt, wid), (3, hgt, wid),
              (hgt, wid), (6, 3, hgt, wid), (6, hgt, wid), (6, hgt, wid)]
    ims = [color, depth, sil, rgb, gt_depth] + list(tangents or (None,) * 3)
    names = ("color", "depth", "sil", "rgb", "gt_depth", "dcolor", "ddepth",
             "dsil")
    for x, shape, name in zip(ims, shapes, names):
        if x is None:
            continue
        if x.device != sil.device or x.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 tensor on "
                             f"{sil.device}")
        if tuple(x.shape) != shape or x.stride(-1) != 1:
            raise ValueError(f"{name} must be {shape} with a contiguous "
                             f"last axis, got {tuple(x.shape)}, stride "
                             f"{x.stride()}")
    if hgt * wid >= 2 ** 31 - 256:
        raise ValueError("gn_reduce takes fewer than 2**31 - 256 pixels")
    full = tangents is not None
    st = lambda x, n: x.stride()[:n] if x is not None else (0,) * n
    strides = (*st(color, 2), *st(depth, 1), *st(sil, 1), *st(rgb, 2),
               *st(gt_depth, 1), *st(ims[5], 3), *st(ims[6], 2),
               *st(ims[7], 2))
    dev = sil.device
    h = torch.empty((6, 6), dtype=torch.float32, device=dev) if full else None
    g = torch.empty(6, dtype=torch.float32, device=dev) if full else None
    cost = torch.empty((), dtype=torch.float32, device=dev)
    state, mode, slot = lm if lm is not None else (None, NONE, 0)
    if state is not None:
        for name in ("vec", "costs", "accept"):
            x = getattr(state, name)
            if x.device != dev or not x.is_contiguous():
                raise ValueError(f"the LM state's {name} must be contiguous "
                                 f"on {dev}")
        if state.vec.shape != (STATE,) or state.vec.dtype != torch.float32:
            raise ValueError(f"the LM state must be float32 [{STATE}]")
        if mode in (DEFERRED, PROPOSE) and not 0 <= slot < len(state.costs):
            raise ValueError(f"slot {slot} outside the state's "
                             f"{len(state.costs)} costs")
    part, ticket = _scratch_of(dev)
    ptrs = (ctypes.c_void_p * 8)(*(_ptr(x) for x in ims))
    istr = (ctypes.c_longlong * 14)(*strides)
    dims = (ctypes.c_int * 2)(hgt, wid)
    fpar = (ctypes.c_float * 4)(sil_threshold, sqc, sqd, huber)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("gauss_newton").gn_reduce(
            ctypes.addressof(ptrs), ctypes.addressof(istr),
            ctypes.addressof(dims), ctypes.addressof(fpar), part.data_ptr(),
            ticket.data_ptr(), _ptr(h), _ptr(g), cost.data_ptr(),
            _ptr(None if state is None else state.vec),
            _ptr(None if state is None else state.costs),
            _ptr(None if state is None else state.accept), mode, slot,
            stream)
    if rc != 0:
        raise RuntimeError(f"gn_reduce launch failed: CUDA error {rc}")
    launches["gn_reduce"] += 1
    return h, g, cost
