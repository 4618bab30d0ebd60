"""What every timed entry of the program shares.

A mix file (``mixes/<name>.json``) names its entry; each entry is a file
of its own, ``entries/<entry>.py``, that defines ``ENTRY``, a subclass of
:class:`Entry`, and is found by that name (``cells.entry``).  An entry
builds its inputs from the seed (the scene, the camera path, the targets
rendered by the reference), runs its set-up, then one unit of work per
:meth:`Entry.step`; afterwards it gives the readings that decide
``correct`` (:meth:`Entry.readings`) and the work of a unit that the
rooflines read (:meth:`Entry.work`).

The program is imported here (:func:`port`) and nowhere else in the
benchmark; the reference (``reference.py``) never sees it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference as ref
from . import scene as scn
from .work import Work


def port():
    """The program's modules (imported on first use, never at import)."""
    import diff_gaussian_rasterization_tpu_torch as pkg
    from diff_gaussian_rasterization_tpu_torch import camera, config
    from diff_gaussian_rasterization_tpu_torch.models import (gaussians,
                                                              runner, slam)
    from diff_gaussian_rasterization_tpu_torch.ops import rasterize
    from diff_gaussian_rasterization_tpu_torch.ops.kernels import _build
    return dict(port=pkg, camera=camera, config=config, gaussians=gaussians,
                runner=runner, slam=slam, rasterize=rasterize, build=_build)


def build_kernels(device):
    """Build (or load) the program's CUDA kernels: set-up, never inside the
    window."""
    if torch.device(device).type == "cuda":
        port()["build"].build_all()


def ref_cam(cfg: dict) -> ref.Cam:
    c = cfg["camera"]
    return ref.Cam(c["height"], c["width"], c["width"] / (2.0 * c["fx"]),
                   c["height"] / (2.0 * c["fy"]))


def norm_gap(a: dict, b: dict, skip=()):
    """The worst leaf's gap between two sets of norms: ``|a - b|`` over
    the larger of ``b`` and the median of ``b``'s leaves."""
    keys = [k for k in b if k not in skip]
    med = float(np.median([b[k] for k in b]))
    return max((abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in keys),
               default=0.0)


def leaf_norms(d: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def quiet_leaves(ref_norms: dict) -> list:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: Adam moves them by round-off alone, so their change is not
    compared."""
    med = float(np.median(list(ref_norms.values())))
    return [k for k, x in ref_norms.items() if x < 1e-3 * med]


class Entry:
    """What every entry shares: the configuration, the mix, the seed, the
    device and the program's configuration objects."""

    unit = "steps"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.dev = torch.device(device)
        self.P = port()
        self.cam = ref_cam(cfg)
        self.R = ref.Raster.of(cfg["raster"])
        self.faults = {}
        self.exhausted = False

    # what each entry defines

    def setup(self):
        """Set-up after the inputs: warm-up and the first units."""

    def step(self):
        """One unit of work of the window."""
        raise NotImplementedError

    def after_window(self):
        """Whatever the check needs from the program once the window has
        closed (nothing by default)."""

    def release(self):
        """Free the program's state before the reference runs."""

    def readings(self, tf32_control: bool = False) -> dict:
        """The numbers compared, each against its limit."""
        raise NotImplementedError

    def work(self) -> Work:
        return Work.none()

    # shared helpers

    def program_camera(self, view):
        return self.P["camera"].Camera(
            viewmatrix=view, tanfovx=self.cam.tanfovx,
            tanfovy=self.cam.tanfovy, height=self.cam.height,
            width=self.cam.width)

    def raster_config(self, **kw):
        r = {k: v for k, v in self.cfg["raster"].items()}
        r.update(kw)
        return self.P["config"].RasterConfig(**r)

    def model_of(self, fields: dict):
        g = self.P["gaussians"]
        return g.GaussianModel(*(fields[k].clone() for k in ref.FIELDS),
                               fields["active"].clone())

    def views(self, n: int):
        return scn.walkthrough(n, self.cfg["scene"]["layout_seed"],
                               self.cfg["scene"]["extent"])

    def t32(self, v):
        return torch.as_tensor(np.asarray(v, np.float32), device=self.dev)

    def targets(self, fields: dict, views64, noise_seed: int):
        """The sensor frames at ``views64``, rendered by the reference."""
        s = self.cfg.get("sensor", {})
        gen = torch.Generator(device=self.dev).manual_seed(noise_seed)
        f = ref.gaussian_fields(*(fields[k] for k in ref.FIELDS),
                                fields["active"])
        rgbs, depths = [], []
        for v in views64:
            rgb, d = ref.target_frame(f, self.t32(v), self.cam, self.R,
                                      s.get("rgb_noise", 0.0),
                                      s.get("depth_noise", 0.0), gen)
            rgbs.append(rgb)
            depths.append(d)
        return torch.stack(rgbs), torch.stack(depths)

    def budget(self, fields, views):
        """The instance budget: ``budget_scale`` x the largest true count
        over ``views``, rounded up to 1024."""
        model = self.model_of(fields)
        cfg = self.raster_config()
        rz = self.P["rasterize"]
        with torch.no_grad():
            n = max(int(rz.count_instances(
                model.means3D, self.program_camera(v), cfg,
                **model.raster_kwargs())) for v in views)
        scale = self.cfg["raster_budget_scale"]
        return int(-(-int(n * scale) // 1024) * 1024), n


# --------------------------------------------------------------------------
# the dual render and the tracker, shared by the entries that track
# --------------------------------------------------------------------------


class DualTap:
    """Keeps the outputs of the next dual render (``rasterize_with_pose_jvp``
    as the tracker calls it) once armed: the first Gauss-Newton evaluation
    of a tracked frame, at its start pose.  The colour, depth and
    silhouette images and their six pose tangents, flattened as
    :func:`reference.dual_render` gives them, and the camera's size."""

    def __init__(self, slam_mod):
        self.slam = slam_mod
        self.orig = slam_mod.rasterize_with_pose_jvp
        self.armed = False
        self.got = None

    def install(self):
        orig = self.orig

        def tapped(means3D, camera, cfg, view_tangents, **kw):
            j = orig(means3D, camera, cfg, view_tangents, **kw)
            if self.armed:
                self.armed = False
                flat = lambda xs: torch.cat([x.reshape(-1) for x in xs])
                self.got = dict(
                    size=(camera.height, camera.width),
                    prim=flat([j.out.color, j.out.depth,
                               j.out.opacity_map]).clone(),
                    tans=torch.stack([flat([j.color[k], j.depth[k],
                                            j.opacity_map[k]])
                                      for k in range(j.color.shape[0])]))
            return j

        self.slam.rasterize_with_pose_jvp = tapped

    def remove(self):
        self.slam.rasterize_with_pose_jvp = self.orig


MISMATCH = 1e-3    # of a component's RMS: far above float32 rounding


def mismatch(a, b, sizes) -> float:
    """The share of entries of ``a`` that depart from ``b`` by more than
    ``MISMATCH`` of their component's RMS in ``b`` (``sizes`` splits the
    last axis into colour, depth and silhouette).  A pair whose alpha sits
    on the alpha floor to within rounding can blend on one side and not
    the other, which moves a pixel a long way; such pixels are few, so
    they leave this share near zero, where an error of every splat's
    position or colour moves most entries."""
    bad = total = 0
    for pa, pb in zip(torch.split(a, sizes, -1), torch.split(b, sizes, -1)):
        rms = torch.sqrt((pb.double() ** 2).mean())
        bad += int(((pa - pb).abs().double() > MISMATCH * rms).sum())
        total += pb.numel()
    return bad / max(total, 1)


def jvp_gap(got: dict, fields, view0, cam: ref.Cam, R: ref.Raster,
            tf32_control: bool = False) -> float:
    """The dual render's gap: the mismatch share (:func:`mismatch`) of its
    images and of their six pose tangents against the reference's at the
    same pose and size (the larger of the two)."""
    h, w = got["size"]
    c = ref.Cam(h, w, cam.tanfovx, cam.tanfovy)
    prim, tans = ref.dual_render(fields, view0, c, R)
    if tf32_control:
        gp, gt = ref.dual_render(fields, view0, c, R, tf32=True)
    else:
        gp, gt = got["prim"], got["tans"]
    sizes = [3 * h * w, h * w, h * w]
    return max(mismatch(gp, prim, sizes), mismatch(gt, tans, sizes))


def tcfg_dict(t: dict) -> dict:
    """A tracking configuration as the reference takes it, with the
    program's defaults filled in."""
    d = dict(iters=12, method="gn", huber=0.05, lam0=1e-4, w_color=1.0,
             w_depth=0.25, sil_threshold=0.99, pyramid=1, coarse_iters=5,
             freeze_binning=False, bin_margin_px=8.0, line_search=False)
    d.update(t)
    if d["method"] != "gn":
        raise ValueError("the reference tracks by Gauss-Newton only")
    return d


def pose_gap(got, want) -> float:
    """The largest entry gap between two view matrices."""
    return float((got - want).abs().max())
