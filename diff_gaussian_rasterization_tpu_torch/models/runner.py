"""End-to-end Gaussian-splatting SLAM: tracking, keyframes, mapping and
pose-graph refinement (PyTorch port of the JAX package's
``models/runner.py``).

Stream RGB-D frames, track each frame's pose against the map (pose-only
Gauss-Newton), keep keyframes and seed the map where it does not cover
them, map a window of keyframes every few frames (Adam on the Gaussians),
and refine the keyframe graph with the pose-graph solver.  The map and its
optimizer live on the frames' device; the keyframe logic, the seeding
(``backproject``), the window choice and the pose graph run on the host in
numpy, as in the JAX version, and read a few values from the device each
frame (the tracking cost, the silhouette of a coverage or seeding render,
its instance count, the last poses).

With ``SLAMConfig.mesh`` (a ``torch.distributed`` DeviceMesh) every rank
runs the same loop on the same frames and keeps the same replicated
state: mapping shards the keyframe window over ``kf_axis``, renders shard
their tiles over ``tile_axis``, ``map_axis`` shards the map (with
``kf_axis``, in one composed step), and refinement runs the edge-sharded
pose-graph solver (``parallel/sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..camera import Camera
from ..config import RasterConfig
from ..ops.sh import rgb_to_sh0
from ..utils import profiling as prof
from . import lie
from .gaussians import DensifyState, GaussianModel, init_model
from .slam import (Frame, MapOptimizer, MappingConfig, TrackingConfig,
                   make_map_optimizer, mapping_round, render_model,
                   track_frame)


@dataclasses.dataclass
class SLAMConfig:
    """The JAX package's ``SLAMConfig``, field for field (see its comments
    for the measurements behind each default)."""

    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    tracking: TrackingConfig = dataclasses.field(
        default_factory=TrackingConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    capacity: int = 200_000
    keyframe_every: int = 8
    window: int = 4             # keyframes per mapping round
    map_every: int = 8
    seed_every_px: int = 16     # backproject every Nth pixel when seeding
    init_iters: int = 50        # bootstrap mapping steps on the first frame
    motion_model: bool = True   # constant-velocity tracking initialization
    pose_graph_refine: bool = False  # refine the keyframe chain at the end
    refine_every: int = 0       # also refine every N keyframes (0 = off)
    # Coverage-triggered keyframing: when the share of valid-depth pixels
    # whose rendered silhouette exceeds 0.5 drops below this, insert a
    # keyframe (seeding the holes) and map at once.  0 disables.
    kf_min_coverage: float = 0.0
    # mapping iterations of a coverage-triggered round (0 = mapping.iters)
    coverage_map_iters: int = 0
    # no coverage trigger within this many frames of the last keyframe
    kf_coverage_cooldown: int = 0
    # Relocalization: a frame is lost when its cost exceeds reloc_spike x
    # the median of the recent frames or its silhouette covers less than
    # reloc_min_coverage of its valid-depth pixels; it is then re-tracked
    # from the reloc_candidates nearest keyframe poses and the best
    # coverage-normalized cost kept.  0 disables.
    reloc_spike: float = 0.0
    reloc_candidates: int = 2
    reloc_min_coverage: float = 0.5
    reloc_track_iters: int = 0  # 0 = tracking.iters
    # mapping window: "random" = latest + uniform random older keyframes;
    # "nearest" = latest + nearest older by pose, one random slot
    window_select: str = "random"
    # distribution: a torch.distributed DeviceMesh enables, per axis name
    # present with more than one rank, kf_axis: keyframe-parallel mapping;
    # tile_axis: tile-sharded renders in tracking and mapping; map_axis:
    # the map sharded, each frame gathering its visible subset (composed
    # with kf_axis in one mapping step); and refinement through the
    # edge-sharded solver (parallel.sharded.refine_poses_sharded)
    mesh: object = None
    kf_axis: str = "kf"
    tile_axis: str = "tile"
    map_axis: object = None
    map_budget_per_shard: int = 0   # 0 = capacity / map-axis ranks
    # move map Gaussians with their nearest keyframe's pose correction
    reanchor: bool = True
    # pose-graph measurements: each keyframe re-tracked against the map
    # enters as an edge from pose 0 with this weight
    refine_track_iters: int = 4
    refine_abs_weight: float = 4.0
    # drop a re-tracked edge whose cost exceeds gate x the lower-half
    # median (0 = off)
    refine_cost_gate: float = 0.0
    # offline polish: re-track every frame against the final map with this
    # many iterations (0 = off); the online trajectory stays on
    # SLAMState.online_views
    final_retrack_iters: int = 0

    def __post_init__(self):
        if self.window_select not in ("random", "nearest"):
            raise ValueError(
                f"window_select must be 'random' or 'nearest', got "
                f"{self.window_select!r}")


@dataclasses.dataclass
class SLAMState:
    model: GaussianModel
    opt: MapOptimizer
    dstate: DensifyState
    kf_views: List
    kf_frames: List
    est_views: List
    rng: torch.Generator
    # frame index of each keyframe (trajectory-correction anchors)
    kf_idx: List = dataclasses.field(default_factory=lambda: [0])
    # per-frame converged tracking costs (relocalization baseline)
    track_costs: List = dataclasses.field(default_factory=list)
    # the run's RasterConfig with the instance budget sized from the
    # bootstrapped map (init_slam)
    raster: Optional[RasterConfig] = None
    # pre-polish trajectory (set by final_retrack)
    online_views: Optional[List] = None


def _np64(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


def _tensor(v, device) -> torch.Tensor:
    """A float32 view matrix (tensor or numpy) on ``device``."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def backproject(frame: Frame, view, cam_t: Camera, stride: int):
    """Seed Gaussians from an RGB-D frame: unproject every ``stride``-th
    pixel with valid depth, on the host in float64.  Returns float32
    (means, colors, scales) on the frame's device."""
    h, w = cam_t.height, cam_t.width
    depth = frame.depth.detach().cpu().numpy()
    rgb = frame.rgb.detach().cpu().numpy()
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    ys, xs = ys.ravel(), xs.ravel()
    d = depth[ys, xs]
    ok = d > 0
    ys, xs, d = ys[ok], xs[ok], d[ok]
    # pixel -> camera ray (pinhole, principal point at center)
    x_cam = (xs + 0.5 - w / 2) / cam_t.focal_x * d
    y_cam = (ys + 0.5 - h / 2) / cam_t.focal_y * d
    pts_cam = np.stack([x_cam, y_cam, d], -1)
    # camera -> world: p_view = p_world @ V[:3,:3] + V[3,:3]
    v = view.detach().cpu().numpy() if torch.is_tensor(view) \
        else np.asarray(view)
    rot = v[:3, :3]
    pts_world = (pts_cam - v[3, :3]) @ np.linalg.inv(rot)
    colors = rgb[:, ys, xs].T
    # isotropic scale ~ pixel footprint at that depth
    scale = d / cam_t.focal_x * stride * 0.7
    scales = np.stack([scale] * 3, -1)
    dev = frame.depth.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(pts_world), t(colors), t(scales)


def add_gaussians(model: GaussianModel, means, colors, scales,
                  opacity_logit: float = 1.5) -> int:
    """Write new Gaussians into the first free slots, in place; returns how
    many were written (fewer than given when the capacity runs out)."""
    n = means.shape[0]
    with torch.no_grad():
        free = torch.argsort(model.active.to(torch.int8), stable=True)[:n]
        ok = ~model.active[free]
        n_ok = free.shape[0]
        rows = dict(
            means3D=means[:n_ok],
            scales_log=torch.log(torch.clamp_min(scales[:n_ok], 1e-6)),
            opacities_logit=torch.full((n_ok, 1), opacity_logit,
                                       dtype=means.dtype,
                                       device=means.device),
            rotations=torch.tensor([1.0, 0, 0, 0], dtype=means.dtype,
                                   device=means.device).repeat(n_ok, 1))
        for name, r in rows.items():
            param = getattr(model, name)
            param[free] = torch.where(ok[:, None], r, param[free])
        model.sh[free, 0] = torch.where(ok[:, None],
                                        rgb_to_sh0(colors[:n_ok]),
                                        model.sh[free, 0])
        model.active[free] = model.active[free] | ok
    return int(ok.sum())


def _dist_kw(scfg: SLAMConfig) -> dict:
    """mapping_round's distribution arguments from the SLAM config."""
    return dict(mesh=scfg.mesh, kf_axis=scfg.kf_axis,
                tile_axis=scfg.tile_axis, map_axis=scfg.map_axis,
                map_budget=scfg.map_budget_per_shard)


def _track_kw(scfg: SLAMConfig) -> dict:
    return dict(mesh=scfg.mesh, tile_axis=scfg.tile_axis,
                map_axis=scfg.map_axis, map_budget=scfg.map_budget_per_shard)


def _budget(num_rendered) -> int:
    """2.5x the instance count, rounded up to 1024."""
    return int(-(-int(num_rendered) * 2.5 // 1024) * 1024)


def init_slam(first_view, first_frame: Frame, cam_t: Camera,
              scfg: SLAMConfig) -> SLAMState:
    """Seed the map from the first frame on the frame's device, bootstrap it
    with ``scfg.init_iters`` mapping steps, and size the instance budget
    from the bootstrapped map (2.5x its count) unless the config sets
    one."""
    dev = first_frame.depth.device
    first_view = _tensor(first_view, dev)
    model = init_model(scfg.capacity, sh_degree=0, device=dev)
    add_gaussians(model, *backproject(first_frame, first_view, cam_t,
                                      scfg.seed_every_px))
    state = SLAMState(
        model=model, opt=make_map_optimizer(model, scfg.mapping),
        dstate=DensifyState.zero(scfg.capacity, device=dev),
        kf_views=[first_view], kf_frames=[first_frame],
        est_views=[first_view], rng=torch.Generator().manual_seed(0))
    # bootstrap mapping: tracking accuracy is bounded by map quality, and
    # raw backprojected blobs are a poor map
    if scfg.init_iters > 0:
        icfg = dataclasses.replace(scfg.mapping, iters=scfg.init_iters)
        kf = (first_view[None], first_frame.rgb[None],
              first_frame.depth[None])
        state.dstate, _ = mapping_round(
            state.model, state.opt, state.dstate, kf, scfg.raster, icfg,
            cam_t, state.rng, **_dist_kw(scfg))
    state.raster = scfg.raster
    if scfg.raster.max_instances is None:
        with torch.no_grad():
            probe = render_model(state.model,
                                 cam_t.replace(viewmatrix=first_view),
                                 scfg.raster)
        state.raster = scfg.raster.replace(
            max_instances=max(_budget(probe.num_rendered), 1024))
    return state


def _coverage(out, frame: Frame) -> float:
    """Share of the frame's valid-depth pixels whose silhouette exceeds
    0.5 (1.0 when no pixel has depth)."""
    dv = frame.depth > 0
    n = int(dv.sum())
    if n == 0:
        return 1.0
    return float(((out.opacity_map[0] > 0.5) & dv).sum()) / n


@prof.spanned("slam.step")
def slam_step(state: SLAMState, frame: Frame, cam_t: Camera,
              scfg: SLAMConfig, frame_idx: int):
    """Process one frame: track; maybe keyframe, refine and map.  Returns
    ``(state, tracking cost)``."""
    rcfg = state.raster if state.raster is not None else scfg.raster
    dev = state.est_views[-1].device
    # constant-velocity motion model (row convention:
    # X_pred = X_{k-1} X_{k-2}^{-1} X_{k-1})
    if scfg.motion_model and len(state.est_views) >= 2:
        x1, x2 = _np64(state.est_views[-1]), _np64(state.est_views[-2])
        view0 = lie.orthonormalize_view(
            _tensor(x1 @ np.linalg.inv(x2) @ x1, dev))
    else:
        view0 = state.est_views[-1]
    with prof.span("slam.track"):
        view, loss, _ = track_frame(state.model, view0, frame, rcfg,
                                    scfg.tracking, cam_t, **_track_kw(scfg))

        def coverage_render(v):
            with torch.no_grad():
                out = render_model(state.model,
                                   cam_t.replace(viewmatrix=v), rcfg)
            return out, _coverage(out, frame)

        # relocalization: flag the frame lost when its cost spikes above the
        # recent baseline or its silhouette coverage collapses; retry from the
        # nearest keyframe poses, keep the best coverage-normalized cost
        out = cov = None
        if scfg.reloc_spike > 0 and len(state.track_costs) >= 4:
            base = float(np.median(state.track_costs[-8:]))
            out, cov = coverage_render(view)
            if (float(loss) > scfg.reloc_spike * max(base, 1e-12)
                    or cov < scfg.reloc_min_coverage):
                v0 = _np64(view0)
                c0 = -v0[3, :3] @ np.linalg.inv(v0[:3, :3]).T
                ax0 = v0[:3, 2]

                def dist(v):
                    v = _np64(v)
                    c = -v[3, :3] @ np.linalg.inv(v[:3, :3]).T
                    return (np.linalg.norm(c - c0)
                            + 2.0 * (1.0 - float(v[:3, 2] @ ax0)))

                nscore = lambda l, cv: float(l) / max(cv, 0.05)
                best = nscore(loss, cov)
                # candidates start a keyframe gap away: always coarse to fine
                tcfg_r = dataclasses.replace(
                    scfg.tracking,
                    iters=(scfg.reloc_track_iters if scfg.reloc_track_iters > 0
                           else scfg.tracking.iters),
                    pyramid=max(scfg.tracking.pyramid, 2))
                order = np.argsort([dist(v) for v in state.kf_views])
                for i in order[:max(scfg.reloc_candidates, 0)]:
                    v2, l2, _ = track_frame(state.model, state.kf_views[i],
                                            frame, rcfg, tcfg_r, cam_t,
                                            **_track_kw(scfg))
                    out2, cov2 = coverage_render(v2)
                    s2 = nscore(l2, cov2)
                    if s2 < best:
                        best, view, loss, out, cov = s2, v2, l2, out2, cov2
        state.track_costs.append(float(loss))
        state.est_views.append(view)

    with prof.span("slam.keyframe"):
        kf_due = frame_idx % scfg.keyframe_every == 0
        cov_trigger = False
        cooled = (not state.kf_idx
                  or frame_idx - state.kf_idx[-1] >= scfg.kf_coverage_cooldown)
        if scfg.kf_min_coverage > 0 and not kf_due and cooled:
            if cov is None:
                out, cov = coverage_render(view)
            cov_trigger = cov < scfg.kf_min_coverage

        if kf_due or cov_trigger:
            state.kf_views.append(view)
            state.kf_frames.append(frame)
            state.kf_idx.append(frame_idx)
            if out is None:
                with torch.no_grad():
                    out = render_model(state.model,
                                       cam_t.replace(viewmatrix=view), rcfg)
            # regrow the instance budget when a keyframe's true instance count
            # reaches 80% of it, before any render overflows
            if (rcfg.max_instances is not None
                    and int(out.num_rendered) > 0.8 * rcfg.max_instances):
                state.raster = rcfg = rcfg.replace(
                    max_instances=_budget(out.num_rendered))
            # seed unobserved regions: pixels with low silhouette
            holes = Frame(rgb=frame.rgb, depth=torch.where(
                out.opacity_map[0] < 0.5, frame.depth,
                torch.zeros_like(frame.depth)))
            means, colors, scales = backproject(holes, view, cam_t,
                                                scfg.seed_every_px)
            if means.shape[0] > 0:
                add_gaussians(state.model, means, colors, scales)

    if (scfg.refine_every and len(state.kf_views) >= 3
            and frame_idx % (scfg.refine_every * scfg.keyframe_every) == 0):
        with prof.span("slam.refine"):
            state = refine_keyframes(state, scfg, cam_t)

    if ((frame_idx % scfg.map_every == 0 or cov_trigger)
            and len(state.kf_views) >= 1):
        with prof.span("slam.map_round"):
            # the latest keyframe anchors the window, older ones per
            # scfg.window_select
            idx = _select_window(state, scfg, frame_idx)
            kf = (torch.stack([state.kf_views[i] for i in idx]),
                  torch.stack([state.kf_frames[i].rgb for i in idx]),
                  torch.stack([state.kf_frames[i].depth for i in idx]))
            mcfg = scfg.mapping
            if cov_trigger and scfg.coverage_map_iters > 0:
                mcfg = dataclasses.replace(mcfg, iters=scfg.coverage_map_iters)
            state.dstate, _ = mapping_round(
                state.model, state.opt, state.dstate, kf, rcfg, mcfg, cam_t,
                state.rng, **_dist_kw(scfg))
    return state, float(loss)


def _select_window(state: SLAMState, scfg: SLAMConfig,
                   frame_idx: int) -> np.ndarray:
    """Keyframe indices for one mapping round (latest always included)."""
    k = len(state.kf_views)
    n_extra = min(scfg.window, k) - 1
    if k <= 1 or n_extra <= 0:
        return np.array([k - 1])
    rng = np.random.RandomState(frame_idx)
    if scfg.window_select == "nearest":
        # rank older keyframes by camera-center distance + gaze penalty
        # (row convention: center c = -t @ R^T, optical axis = column 2)
        views = np.stack([_np64(v) for v in state.kf_views])
        rot, t = views[:, :3, :3], views[:, 3, :3]
        centers = -np.einsum("kj,kij->ki", t, rot)
        axes = rot[:, :, 2]
        score = (np.linalg.norm(centers[:-1] - centers[-1], axis=-1)
                 + 2.0 * (1.0 - axes[:-1] @ axes[-1]))
        order = np.argsort(score)
        n_near = n_extra - 1 if n_extra >= 2 and k - 1 > n_extra else n_extra
        older = list(order[:n_near])
        rest = [i for i in range(k - 1) if i not in older]
        if len(older) < n_extra and rest:
            older += list(rng.choice(rest, size=min(n_extra - len(older),
                                                    len(rest)),
                          replace=False))
    else:
        older = rng.choice(k - 1, size=min(n_extra, k - 1), replace=False)
    return np.concatenate([[k - 1], older]).astype(int)


def _on_device(frame: Frame, device) -> Frame:
    """A dataset's frame (numpy or tensors) as float32 tensors on
    ``device``."""
    t = lambda a: (a if torch.is_tensor(a) else torch.as_tensor(
        np.asarray(a, np.float32))).to(device=device, dtype=torch.float32)
    return Frame(rgb=t(frame.rgb), depth=t(frame.depth))


def run_slam(dataset, scfg: SLAMConfig, cam_t: Camera,
             max_frames: Optional[int] = None, verbose: bool = False):
    """Track and map an RGB-D sequence; ``dataset`` yields (gt_view,
    Frame).  Each frame is moved once to ``cam_t``'s device, where the
    whole run happens.  The first pose initializes the trajectory (the
    standard SLAM evaluation protocol).  Returns (state, gt_views)."""
    dev = cam_t.viewmatrix.device
    it = iter(dataset)
    gt0, f0 = next(it)
    f0 = _on_device(f0, dev)
    state = init_slam(_tensor(gt0, dev), f0, cam_t, scfg)
    gt_views = [gt0]
    frames_kept = [f0] if scfg.final_retrack_iters > 0 else None
    for i, (gt, frame) in enumerate(it, start=1):
        if max_frames is not None and i >= max_frames:
            break
        frame = _on_device(frame, dev)
        state, loss = slam_step(state, frame, cam_t, scfg, i)
        gt_views.append(gt)
        if frames_kept is not None:
            frames_kept.append(frame)
        if verbose and i % 10 == 0:
            print(f"frame {i}: track loss {loss:.4f}, "
                  f"active {int(state.model.num_active)}", flush=True)
    if scfg.pose_graph_refine and len(state.kf_views) >= 3:
        state = refine_keyframes(state, scfg, cam_t)
    if frames_kept is not None:
        state = final_retrack(state, frames_kept, scfg, cam_t,
                              verbose=verbose)
    return state, gt_views


def final_retrack(state: SLAMState, frames, scfg: SLAMConfig,
                  cam_t: Camera, verbose: bool = False) -> SLAMState:
    """Offline polish: re-track every frame but frame 0 (the gauge) from its
    estimate against the final map; the online trajectory is kept on
    ``state.online_views``."""
    rcfg = state.raster if state.raster is not None else scfg.raster
    tcfg = dataclasses.replace(scfg.tracking,
                               iters=scfg.final_retrack_iters)
    state.online_views = list(state.est_views)
    for f in range(1, len(frames)):
        v, c, _ = track_frame(state.model, state.est_views[f], frames[f],
                              rcfg, tcfg, cam_t, **_track_kw(scfg))
        state.est_views[f] = v
        if verbose and f % 20 == 0:
            print(f"polish frame {f}: cost {float(c):.4f}", flush=True)
    return state


def refine_keyframes(state: SLAMState, scfg: SLAMConfig = None,
                     cam_t: Camera = None):
    """Pose-graph refinement over the keyframe chain, then the trajectory
    and (with ``scfg.reanchor``, or without a config) the map follow.

    Odometry edges come from the estimated chain and carry no residual by
    themselves; with a config each keyframe is re-tracked against the map
    (``refine_track_iters`` iterations) and enters as an edge from pose 0
    weighted ``refine_abs_weight`` (gated by ``refine_cost_gate``).  With
    a config the solver is ``parallel.sharded.refine_poses_sharded``
    (float32; edge-sharded over ``scfg.kf_axis``, or the mesh's first
    axis, when ``scfg.mesh`` is set); without, the native C++ solver.
    Every frame inherits the correction of its latest preceding keyframe,
    ``V_f' = V_f @ inv(V_kf) @ V_kf'``.
    """
    k = len(state.kf_views)
    dev = state.kf_views[0].device if torch.is_tensor(state.kf_views[0]) \
        else "cpu"
    old = np.stack([_np64(v) for v in state.kf_views])
    edges, zs, ws = [], [], []
    for i in range(k - 1):
        edges.append((i, i + 1))
        # row-convention relative: Vj @ inv(Vi) == (Xi^-1 Xj)^T
        zs.append(old[i + 1] @ np.linalg.inv(old[i]))
        ws.append(1.0)
    if (scfg is not None and cam_t is not None
            and scfg.refine_track_iters > 0):
        rcfg = state.raster if state.raster is not None else scfg.raster
        tcfg = dataclasses.replace(scfg.tracking,
                                   iters=scfg.refine_track_iters)
        inv0 = np.linalg.inv(old[0])
        retracked = []
        for j in range(1, k):
            v2, c2, _ = track_frame(state.model, _tensor(old[j], dev),
                                    state.kf_frames[j], rcfg, tcfg, cam_t,
                                    **_track_kw(scfg))
            retracked.append((j, _np64(v2), float(c2)))
        # gate baseline: the median of the lower half of the costs, which
        # a majority of bad re-tracks cannot contaminate
        if retracked:
            cs = np.sort([c for _, _, c in retracked])
            cmed = float(np.median(cs[:max(1, (len(cs) + 1) // 2)]))
        else:
            cmed = 0.0
        for j, v2, c in retracked:
            if (scfg.refine_cost_gate > 0
                    and c > scfg.refine_cost_gate * max(cmed, 1e-12)):
                continue        # immature-map re-track; odometry holds j
            edges.append((0, j))
            zs.append(v2 @ inv0)
            ws.append(scfg.refine_abs_weight)
    if scfg is not None:
        from ..parallel.sharded import refine_poses_sharded
        from ..parallel.mesh import check_mesh
        mesh, axis = scfg.mesh, "kf"
        check_mesh(mesh)
        if mesh is not None:
            axis = (scfg.kf_axis if scfg.kf_axis in mesh.mesh_dim_names
                    else mesh.mesh_dim_names[0])
        refined = refine_poses_sharded(
            old.astype(np.float32), np.asarray(edges, np.int32),
            np.stack(zs).astype(np.float32), mesh=mesh, axis=axis,
            iters=5, weights=np.asarray(ws, np.float32))
    else:
        from .. import native
        refined, _ = native.pose_graph_optimize(
            old, np.asarray(edges), np.stack(zs), iters=5,
            weights=np.asarray(ws))
    refined = [_np64(v) for v in refined]
    state.kf_views = [_tensor(v, dev) for v in refined]

    if scfg is None or scfg.reanchor:
        reanchor_map(state.model, old, refined)

    # trajectory update: correction of the latest preceding keyframe
    if state.kf_idx and state.est_views:
        corr = [np.linalg.inv(o) @ r for o, r in zip(old, refined)]
        j = 0
        for f in range(len(state.est_views)):
            while j + 1 < len(state.kf_idx) and state.kf_idx[j + 1] <= f:
                j += 1
            v = _np64(state.est_views[f]) @ corr[j]
            state.est_views[f] = lie.orthonormalize_view(_tensor(v, dev))
    return state


def reanchor_map(model: GaussianModel, old_views, new_views):
    """Move the active Gaussians with their anchor keyframe's pose
    correction, in place.

    Each active Gaussian is anchored to the nearest old keyframe camera
    center and moved so its camera-frame coordinates under that keyframe
    are kept: row-convention ``[p', 1] = [p, 1] @ V_old @ inv(V_new)``; its
    rotation composes with the correction's world rotation (a quaternion
    product).  Inactive slots are untouched.
    """
    dev = model.means3D.device
    with torch.no_grad():
        old = torch.stack([_tensor(v, dev) for v in old_views])
        new = torch.stack([_tensor(v, dev) for v in new_views])
        corr = old @ torch.linalg.inv(new)                    # [K, 4, 4]
        # camera centers of the old poses
        centers = -torch.einsum("kj,kij->ki", old[:, 3, :3], old[:, :3, :3])
        d2 = ((model.means3D[:, None, :] - centers[None]) ** 2).sum(-1)
        mg = corr[torch.argmin(d2, dim=1)]                    # [P, 4, 4]
        means_new = (torch.einsum("pi,pij->pj", model.means3D,
                                  mg[:, :3, :3]) + mg[:, 3, :3])
        # column-vector world rotation of the correction
        q_corr = lie.quat_from_rotmat(mg[:, :3, :3].transpose(1, 2))
        quats_new = lie.quat_mul(q_corr, model.rotations)
        act = model.active[:, None]
        model.means3D.copy_(torch.where(act, means_new, model.means3D))
        model.rotations.copy_(torch.where(act, quats_new, model.rotations))
    return model


def save_slam(path: str, state: SLAMState):
    """Checkpoint the whole session with ``torch.save``: the map, the Adam
    and schedule state, the densify statistics, the keyframes (poses,
    frames, frame indices), the trajectory, the tracking costs, the
    generator's state and the instance budget; :func:`load_slam` resumes
    it bit for bit."""
    from ..utils.checkpoint import model_tensors

    cpu = lambda vs: torch.stack([v.detach().cpu() for v in vs])
    sched = state.opt.schedule
    torch.save({
        "model": model_tensors(state.model),
        "adam": state.opt.adam.state_dict(),
        "schedule": None if sched is None else sched.state_dict(),
        "dstate": {"grad_accum": state.dstate.grad_accum.cpu(),
                   "denom": state.dstate.denom.cpu()},
        "est_views": cpu(state.est_views),
        "kf_views": cpu(state.kf_views),
        "kf_idx": list(state.kf_idx),
        "kf_rgb": cpu([f.rgb for f in state.kf_frames]),
        "kf_depth": cpu([f.depth for f in state.kf_frames]),
        "track_costs": list(state.track_costs),
        "rng": state.rng.get_state(),
        "max_instances": (-1 if state.raster is None
                          or state.raster.max_instances is None
                          else int(state.raster.max_instances)),
    }, path)


def load_slam(path: str, scfg: SLAMConfig, device="cuda") -> SLAMState:
    """Restore a session saved by :func:`save_slam` onto ``device``.
    ``scfg`` must match the saved run's mapping config (the optimizer is
    rebuilt from it before its state is loaded)."""
    from ..utils.checkpoint import model_from_tensors

    p = torch.load(path, map_location="cpu", weights_only=True)
    model = model_from_tensors(p["model"], device)
    opt = make_map_optimizer(model, scfg.mapping)
    opt.adam.load_state_dict(p["adam"])
    if opt.schedule is not None:
        opt.schedule.load_state_dict(p["schedule"])
    rng = torch.Generator()
    rng.set_state(p["rng"])
    mi = int(p["max_instances"])
    to = lambda x: x.to(device)
    return SLAMState(
        model=model, opt=opt,
        dstate=DensifyState(grad_accum=to(p["dstate"]["grad_accum"]),
                            denom=to(p["dstate"]["denom"])),
        kf_views=[to(v) for v in p["kf_views"]],
        kf_frames=[Frame(rgb=to(r), depth=to(d))
                   for r, d in zip(p["kf_rgb"], p["kf_depth"])],
        est_views=[to(v) for v in p["est_views"]],
        rng=rng, kf_idx=[int(i) for i in p["kf_idx"]],
        track_costs=[float(c) for c in p["track_costs"]],
        raster=None if mi < 0 else scfg.raster.replace(max_instances=mi))
