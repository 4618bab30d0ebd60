"""``track_frame`` of targets from a pool of walkthrough frames, closed
loop (mix keys: ``pool``, ``pool_stride``, ``cycles``, ``warm``,
``check``, ``check_span``)."""

import math
import time

import numpy as np
import torch

from splatbench import entry as E
from splatbench import reference as ref
from splatbench import scene as scn
from splatbench import work as W


class TrackEntry(E.Entry):
    """Each request tracks one target from the constant-velocity
    prediction of the two walkthrough poses before it, the next request
    once it has returned."""

    unit = "frames"

    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        sc = cfg["scene"]
        n = mix["pool"] * mix["pool_stride"] + 2
        traj = self.views(n)
        self.ids = np.arange(2, n, mix["pool_stride"])[:mix["pool"]]
        truth = scn.room(sc, self.seed, self.dev)
        self.rgbs, self.depths = self.targets(truth, traj[self.ids],
                                              self.seed + 2)
        self.fields = truth
        self.view0 = self.t32(np.stack([scn.predicted(traj[i - 2],
                                                      traj[i - 1])
                                        for i in self.ids]))
        self.max_instances, self.instances = self.budget(
            truth, self.t32(traj[self.ids]))
        self.rcfg = self.raster_config(max_instances=self.max_instances)
        slam = self.P["slam"]
        self.tcfg = slam.TrackingConfig(**cfg["tracking"])
        self.model = self.model_of(truth)
        self.template = self.program_camera(self.view0[0])
        rng = np.random.default_rng(self.seed)
        self.order = np.concatenate([rng.permutation(mix["pool"])
                                     for _ in range(mix["cycles"])])
        self.done = []     # (pool index, view, cost, latency s)
        # the requests whose answers are checked, drawn from the seed among
        # the first ``check_span`` of the window
        rng = np.random.default_rng(self.seed + 3)
        self.checked = sorted(rng.choice(mix["check_span"], mix["check"],
                                         replace=False).tolist())
        self.tap = E.DualTap(self.P["slam"])
        self.taps = {}

    def request(self, i: int):
        slam = self.P["slam"]
        track = self.faults.get("track_frame", slam.track_frame)
        frame = slam.Frame(self.rgbs[i], self.depths[i])
        view, cost, _ = track(self.model, self.view0[i], frame, self.rcfg,
                              self.tcfg, self.template)
        return view, cost

    def step(self):
        k = len(self.done)
        i = int(self.order[k % self.order.shape[0]])
        self.tap.armed = k in self.checked
        t0 = time.perf_counter()
        view, cost = self.request(i)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.done.append((i, view, cost, time.perf_counter() - t0))
        if k in self.checked:
            self.taps[k] = self.tap.got

    def setup(self):
        """Warm both pyramid levels' shapes on a frame the window repeats
        (its result is not kept)."""
        self.tap.install()
        for _ in range(self.mix["warm"]):
            self.request(int(self.order[0]))

    def release(self):
        self.tap.remove()
        del self.model

    def reference_track(self, i: int, tf32: bool):
        f = ref.gaussian_fields(*(self.fields[k] for k in ref.FIELDS),
                                self.fields["active"])
        return ref.track(f, self.view0[i], self.rgbs[i], self.depths[i],
                         self.cam, self.R, E.tcfg_dict(self.cfg["tracking"]),
                         tf32=tf32)

    def readings(self, tf32_control: bool = False):
        """Over the checked requests the window completed: the largest
        entry gap of the tracked pose (``pose_gap``) and the first dual
        render's gap (``jvp_gap``), against the reference."""
        f = ref.gaussian_fields(*(self.fields[k] for k in ref.FIELDS),
                                self.fields["active"])
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
            jvp.append(math.inf if tap is None else E.jvp_gap(
                tap, f, self.view0[i], self.cam, self.R, tf32_control))
        return dict(pose_gap=max(pose, default=math.inf),
                    jvp_gap=max(jvp, default=math.inf))

    def work(self) -> W.Work:
        """A tracked frame: per pyramid level its frozen binning, and per
        Gauss-Newton iteration one dual render (the render and six
        tangents) with the preprocess and its six forward-mode tangents;
        the pool's mean counts at the start poses."""
        t = self.cfg["tracking"]
        levels = [(2 ** lv, t.get("coarse_iters", 5))
                  for lv in range(max(t.get("pyramid", 1), 1) - 1, 0, -1)]
        levels.append((1, t.get("iters", 12)))
        p = int(self.fields["active"].numel())
        pieces = dict(render_jvp=W.ZERO, preprocess=W.ZERO, binning=W.ZERO)
        for s, iters in levels:
            cam = self.cam.scaled(s)
            counts = W.pool_counts(self.fields, self.view0, cam, self.R)
            inst = sum(c[0] for c in counts) / len(counts)
            contrib = sum(c[1] for c in counts) / len(counts)
            px = cam.height * cam.width
            pieces["render_jvp"] += W.blend_jvp(
                inst, contrib, px, W.tiles(cam, self.R)).scaled(iters)
            pieces["preprocess"] += W.preprocess(p).scaled(7 * iters + 1)
            pieces["binning"] += W.binning(inst)
        return W.Work(pieces)


ENTRY = TrackEntry
