"""The ranks' side of the port's distributed tests (``test_torch_dist_*``).

Each ``*_cases`` function runs in every rank of a world that
``parallel.mesh.spawn`` starts (gloo, on the CPU): it rebuilds its inputs
from the numpy arrays the test process made, runs the meshed path and its
one-rank counterpart, and returns numpy arrays that the test process holds
against each other, against the other ranks' and against the JAX
package's.  It imports torch and the port only (no JAX), so that a rank
starts quickly.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from diff_gaussian_rasterization_tpu_torch.camera import Camera
from diff_gaussian_rasterization_tpu_torch.config import RasterConfig
from diff_gaussian_rasterization_tpu_torch.models import lie
from diff_gaussian_rasterization_tpu_torch.parallel.mesh import (host_store,
                                                                  make_mesh)

OUT_FIELDS = ("color", "depth", "depth_median", "depth_var", "opacity_map",
              "gau_uncertainty", "gau_related_pixels", "n_contrib",
              "n_valid", "radii", "num_rendered", "overflow")


@contextlib.contextmanager
def one_rank_world():
    """A world of one rank (gloo) in this process, for the meshed paths'
    checks that need no second rank."""
    dist.init_process_group("gloo", store=host_store(), world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _t(x):
    return torch.as_tensor(np.array(x))


def _camera(cam: dict, view=None) -> Camera:
    return Camera(viewmatrix=_t(cam["view"]) if view is None else view,
                  tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
                  height=cam["height"], width=cam["width"])


def _fields(out) -> dict:
    return {k: getattr(out, k).detach() for k in OUT_FIELDS}


def twist_basis(view):
    """The six twist-basis tangents of ``view`` [6, 4, 4]."""
    tw = torch.func.jacfwd(lambda x: lie.apply_twist(view, x))(
        torch.zeros(6, dtype=view.dtype))
    return tw.movedim(-1, 0)


def render_cases(rank, n, scene, cam, cfg_kw):
    """Tile-sharded ``rasterize`` (forward and backward, with and without
    ``shard_binning``), the per-shard overflow, and the tile-sharded dual
    render, each beside its one-rank counterpart."""
    from diff_gaussian_rasterization_tpu_torch.ops.projection import (
        preprocess)
    from diff_gaussian_rasterization_tpu_torch.ops.rasterize import (
        rasterize, rasterize_with_pose_jvp)
    from diff_gaussian_rasterization_tpu_torch.ops.tiling import grid_dims
    from diff_gaussian_rasterization_tpu_torch.parallel.shard_bin import (
        band_instance_counts)

    mesh = make_mesh((1, n), ("kf", "tile"), backend="gloo")
    cfg = RasterConfig(**cfg_kw)
    kw = {k: _t(v) for k, v in scene.items() if k != "means3D"}

    def render(mesh_arg, sb=False):
        means = _t(scene["means3D"]).requires_grad_(True)
        view = _t(cam["view"]).requires_grad_(True)
        out = rasterize(means, _camera(cam, view), cfg, mesh=mesh_arg,
                        shard_binning=sb, **kw)
        loss = (out.color.sum() + 0.3 * out.depth.sum()
                + 0.1 * out.depth_median.sum() + 0.1 * out.opacity_map.sum())
        loss.backward()
        return dict(out=_fields(out), g_means=means.grad, g_view=view.grad)

    res = dict(one=render(None), tile=render(mesh), sb=render(mesh, True))

    camera = _camera(cam)
    prep_kw = {k: v for k, v in kw.items() if k not in ("bg", "gt_depth")}
    prep = preprocess(_t(scene["means3D"]), camera, cfg, **prep_kw)
    _, tiles_y = grid_dims(camera.height, camera.width, cfg.tile_h,
                           cfg.tile_w)
    counts = band_instance_counts(prep, n, -(-tiles_y // n))
    deepest = int(counts.max())
    over = lambda cap: rasterize(_t(scene["means3D"]), camera, cfg,
                                 mesh=mesh, shard_binning=True,
                                 max_instances_per_shard=cap, **kw).overflow
    res.update(counts=counts, touched=prep.tiles_touched.sum(),
               ovf_small=over(128), ovf_fit=over(-(-deepest // 128) * 128))

    jkw = {k: v for k, v in kw.items() if k != "gt_depth"}
    tw = twist_basis(camera.viewmatrix)
    dual = lambda m: rasterize_with_pose_jvp(
        _t(scene["means3D"]), camera, cfg, tw, gt_depth=kw["gt_depth"],
        mesh=m, **jkw)
    j1, j2 = dual(None), dual(mesh)
    res["jvp_one"] = dict(_fields(j1.out), dcolor=j1.color, ddepth=j1.depth,
                          dweight=j1.opacity_map)
    res["jvp_mesh"] = dict(_fields(j2.out), dcolor=j2.color, ddepth=j2.depth,
                           dweight=j2.opacity_map)
    try:
        rasterize_with_pose_jvp(_t(scene["means3D"]), camera,
                                cfg.replace(pose_cov2d_branch=True), tw,
                                mesh=mesh, **jkw)
        res["full_raises"] = False
    except ValueError:
        res["full_raises"] = True
    return res


def _model_of(fields: dict):
    from diff_gaussian_rasterization_tpu_torch.convert import (
        gaussian_model_from_numpy)
    return gaussian_model_from_numpy(fields, device="cpu")


def model_arrays(model) -> dict:
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        PARAM_FIELDS)
    return {k: getattr(model, k).detach().clone()
            for k in PARAM_FIELDS + ("active",)}


def mesh_key(shape, names) -> str:
    return ",".join(f"{a}={s}" for a, s in zip(names, shape))


def mapping_cases(rank, n, start, kf, cam, cfg_kw, mcfg_kw, meshes):
    """``mapping_round`` (with ``uncertainty_prune``) from ``start`` on the
    keyframe window ``kf`` on each mesh of ``meshes`` (a list of
    ``(shape, axis names, map_axis, map budget)``, all of this world's
    size) and on one rank: the models after the round, the last step's
    loss and the densification statistics."""
    from diff_gaussian_rasterization_tpu_torch.models.gaussians import (
        DensifyState)
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        MappingConfig, make_map_optimizer, mapping_round)

    cfg = RasterConfig(**cfg_kw)
    mcfg = MappingConfig(**mcfg_kw)
    cam_t = _camera(cam)
    views, rgbs, depths = (_t(x) for x in kf)

    def run(mesh, map_axis, budget=0):
        model = _model_of(start)
        opt = make_map_optimizer(model, mcfg)
        dstate, loss = mapping_round(
            model, opt, DensifyState.zero(model.capacity, device="cpu"),
            (views, rgbs, depths), cfg, mcfg, cam_t, mesh=mesh,
            kf_axis="kf", tile_axis="tile", map_axis=map_axis,
            map_budget=budget)
        return dict(model=model_arrays(model), loss=loss,
                    denom=dstate.denom, grad_accum=dstate.grad_accum)

    res = {"one": run(None, None)}
    for shape, names, map_axis, budget in meshes:
        mesh = make_mesh(shape, names, backend="gloo")
        res[mesh_key(shape, names)] = run(mesh, map_axis, budget)
    return res


def slam_cases(rank, n, views, frames, cam, cfg_kw, scfg_kw, tcfg_kw,
               mcfg_kw, mesh_shape, mesh_names):
    """``run_slam`` on a mesh: the estimated poses and keyframe indices."""
    from diff_gaussian_rasterization_tpu_torch.models.runner import (
        SLAMConfig, run_slam)
    from diff_gaussian_rasterization_tpu_torch.models.slam import (
        Frame, MappingConfig, TrackingConfig)

    mesh = make_mesh(mesh_shape, mesh_names, backend="gloo")
    scfg = SLAMConfig(raster=RasterConfig(**cfg_kw),
                      tracking=TrackingConfig(**tcfg_kw),
                      mapping=MappingConfig(**mcfg_kw), mesh=mesh,
                      **scfg_kw)
    data = [(v, Frame(_t(rgb), _t(d))) for v, (rgb, d) in zip(views, frames)]
    state, _ = run_slam(data, scfg, _camera(cam))
    return dict(est_views=torch.stack(state.est_views),
                kf_idx=np.asarray(state.kf_idx),
                model=model_arrays(state.model))
