"""``track_frame`` with the Full variant's pose chain on a map whose
Gaussians carry SH colour, against ``reference_full.py`` (mix keys as
``track_frame``'s; configuration keys ``scene.sh_degree`` and
``scene.sh_rest_std``, and the raster's ``pose_cov2d_branch`` and
``pose_sh_branch``)."""

import math

import numpy as np
import torch

from splatbench import entry as E
from splatbench import reference as ref
from splatbench import reference_full as rf
from splatbench import scene as scn
from splatbench import work as W
from splatbench import work_full as WF
from splatbench.entries.track_frame import TrackEntry


def sh_bands(fields: dict, scene: dict, seed: int):
    """Make the room's colour SH of degree ``scene["sh_degree"]``, in
    place: the DC term kept, the bands above it drawn from ``seed`` with
    standard deviation ``scene["sh_rest_std"]``, one draw a surface of
    the room (a wall, a box's face), which all its Gaussians share, as
    the Gaussians of one material do.  Bands drawn for each Gaussian on
    its own would add as much image contrast as view dependence, so the
    colour branch would stay under 1% of the pose Jacobian at any
    standard deviation."""
    sh, dev = fields["sh"], fields["sh"].device
    m = (scene["sh_degree"] + 1) ** 2
    rng = np.random.default_rng(scene["layout_seed"])
    counts = [s[3] * s[4] for s in scn._plane_specs(
        scene["wall_res"], scene["n_boxes"], scene["extent"], rng)]
    surface = torch.repeat_interleave(
        torch.arange(len(counts), device=dev),
        torch.tensor(counts, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    draws = scene["sh_rest_std"] * torch.randn(
        (len(counts), m - 1, 3), generator=gen, device=dev)
    rest = sh.new_zeros((sh.shape[0], m - 1, 3))
    rest[:surface.numel()] = draws[surface]
    fields["sh"] = torch.cat([sh[:, :1], rest], 1)


class TrackFullEntry(TrackEntry):
    """:class:`TrackEntry` on the SH map, checked against the full pose
    chain.  A program whose dual render has no SH colour branch (no
    ``rasterize.color_branch``) cannot run this configuration: it stops
    before the room is built."""

    def __init__(self, cfg, mix, seed, device):
        self.branches = dict(cov_branch=bool(cfg["raster"].get(
            "pose_cov2d_branch", False)), sh_branch=bool(cfg["raster"].get(
                "pose_sh_branch", False)))
        if self.branches["sh_branch"] and not hasattr(
                E.port()["rasterize"], "color_branch"):
            raise RuntimeError("the program's dual render has no SH colour "
                               "branch: it cannot run this configuration")
        super().__init__(cfg, mix, seed, device)

    def targets(self, fields, views64, noise_seed):
        """The room made SH (:func:`sh_bands`), in place, before anything
        else reads ``fields``; then the sensor frames at ``views64``,
        rendered by the reference with each view's colours."""
        sh_bands(fields, self.cfg["scene"], self.seed)
        s = self.cfg.get("sensor", {})
        gen = torch.Generator(device=self.dev).manual_seed(noise_seed)
        f = self.full_fields(fields)
        rgbs, depths = [], []
        for v in views64:
            v = self.t32(v)
            rgb, d = ref.target_frame(f[:4] + (rf.colors(f, v),), v,
                                      self.cam, self.R,
                                      s.get("rgb_noise", 0.0),
                                      s.get("depth_noise", 0.0), gen)
            rgbs.append(rgb)
            depths.append(d)
        return torch.stack(rgbs), torch.stack(depths)

    @staticmethod
    def full_fields(fields: dict):
        return rf.gaussian_fields(*(fields[k] for k in ref.FIELDS),
                                  fields["active"])

    def jvp_gap(self, got, f, view0, cam, R, tf32_control=False):
        """``entry.jvp_gap`` against the full reference."""
        h, w = got["size"]
        c = ref.Cam(h, w, cam.tanfovx, cam.tanfovy)
        prim, tans = rf.dual_render(f, view0, c, R, **self.branches)
        if tf32_control:
            gp, gt = rf.dual_render(f, view0, c, R, tf32=True,
                                    **self.branches)
        else:
            gp, gt = got["prim"], got["tans"]
        sizes = [3 * h * w, h * w, h * w]
        return max(E.mismatch(gp, prim, sizes), E.mismatch(gt, tans, sizes))

    def reference_track(self, i: int, tf32: bool):
        return rf.track(self.full_fields(self.fields), self.view0[i],
                        self.rgbs[i], self.depths[i], self.cam, self.R,
                        E.tcfg_dict(self.cfg["tracking"]), tf32=tf32,
                        **self.branches)

    def readings(self, tf32_control: bool = False):
        """``TrackEntry.readings`` against the full reference: the
        tracked pose's largest entry gap (``pose_gap``) and the first dual
        render's mismatch share (``jvp_gap``)."""
        f = self.full_fields(self.fields)
        pose, jvp = [], []
        for j in self.checked:
            if j >= len(self.done):
                continue
            i, view, _, _ = self.done[j]
            r = self.reference_track(i, tf32=False)
            got = self.reference_track(i, tf32=True) if tf32_control \
                else view
            pose.append(E.pose_gap(got, r))
            tap = self.taps.get(j)
            jvp.append(math.inf if tap is None else self.jvp_gap(
                tap, f, self.view0[i], self.cam, self.R, tf32_control))
        return dict(pose_gap=max(pose, default=math.inf),
                    jvp_gap=max(jvp, default=math.inf))

    def colour_share(self, n: int = 2) -> float:
        """The colour branch's share of the pose Jacobian over the pool's
        first ``n`` start views: ``|J - J'|_F / |J|_F`` over the six
        tangents of the reference's dual render, ``J'`` without the
        branch."""
        f = self.full_fields(self.fields)
        num = den = 0.0
        for i in range(n):
            _, full = rf.dual_render(f, self.view0[i], self.cam, self.R,
                                     **self.branches)
            _, lame = rf.dual_render(f, self.view0[i], self.cam, self.R,
                                     **dict(self.branches, sh_branch=False))
            num += float(((full - lame).double() ** 2).sum())
            den += float((full.double() ** 2).sum())
        return math.sqrt(num / den)

    def work(self) -> W.Work:
        """``TrackEntry.work`` with the full chain's dual blends and the
        SH preprocess (``work_full.py``)."""
        t = self.cfg["tracking"]
        levels = [(2 ** lv, t.get("coarse_iters", 5))
                  for lv in range(max(t.get("pyramid", 1), 1) - 1, 0, -1)]
        levels.append((1, t.get("iters", 12)))
        p = int(self.fields["active"].numel())
        deg = self.cfg["scene"]["sh_degree"]
        color = self.branches["sh_branch"] and deg >= 1
        pieces = dict(render_jvp=W.ZERO, preprocess=W.ZERO, binning=W.ZERO)
        for s, iters in levels:
            cam = self.cam.scaled(s)
            counts = W.pool_counts(self.fields, self.view0, cam, self.R)
            inst = sum(c[0] for c in counts) / len(counts)
            contrib = sum(c[1] for c in counts) / len(counts)
            px = cam.height * cam.width
            pieces["render_jvp"] += WF.blend_jvp_full(
                inst, contrib, px, W.tiles(cam, self.R),
                cov=self.branches["cov_branch"], color=color).scaled(iters)
            pieces["preprocess"] += WF.preprocess_sh(p, deg).scaled(
                7 * iters + 1)
            pieces["binning"] += W.binning(inst)
        return W.Work(pieces)


ENTRY = TrackFullEntry
