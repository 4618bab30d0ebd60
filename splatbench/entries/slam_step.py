"""``slam_step`` over a sequence rendered by the reference in set-up (mix
key: ``frames``)."""

import dataclasses
import math

import torch

from splatbench import entry as E
from splatbench import reference as ref
from splatbench import scene as scn


class Recorder:
    """Once armed, keeps the next call of ``track_frame`` and of
    ``map_step`` that the SLAM loop makes, with the state it started from
    and what it returned (the tracked pose and the first dual render; the
    step's parameters and the gradients Adam was given), so that the
    reference can redo them from the program's own state.  Disarmed, it
    passes every call through untouched."""

    def __init__(self, slam_mod, runner_mod):
        self.slam, self.runner = slam_mod, runner_mod
        self.orig = (slam_mod.map_step, runner_mod.track_frame)
        self.tap = E.DualTap(slam_mod)
        self.armed = False
        self.track = self.map = None

    @staticmethod
    def pack(tensors):
        return torch.cat([t.detach().reshape(-1).float() for t in tensors])

    @staticmethod
    def unpack(flat, likes):
        out, o = [], 0
        for t in likes:
            n = t.numel()
            out.append(flat[o:o + n].reshape(t.shape))
            o += n
        return out

    def install(self, faults):
        map_step, track_frame = self.orig
        map_step = faults.get("map_step", map_step)
        track_frame = faults.get("track_frame", track_frame)

        def rec_track(model, view0, frame, cfg, tcfg, cam_t, **kw):
            if not self.armed or self.track is not None:
                return track_frame(model, view0, frame, cfg, tcfg, cam_t,
                                   **kw)
            fields = [getattr(model, k) for k in ref.FIELDS] + [model.active]
            snap = self.pack(fields)
            self.tap.armed = True
            view, cost, costs = track_frame(model, view0, frame, cfg, tcfg,
                                            cam_t, **kw)
            self.tap.armed = False
            self.track = dict(snap=snap, likes=[f.detach() for f in fields],
                              view0=view0.detach().clone(), frame=frame,
                              cfg=cfg, tcfg=tcfg, view=view.detach().clone(),
                              dual=self.tap.got)
            return view, cost, costs

        def rec_map(model, opt, dstate, views, rgbs, depths, wts, cfg, mcfg,
                    *a, **kw):
            if not self.armed or self.map is not None:
                return map_step(model, opt, dstate, views, rgbs, depths, wts,
                                cfg, mcfg, *a, **kw)
            params = [getattr(model, k) for k in ref.FIELDS]
            st = opt.adam.state
            moms = [st[p][n] if p in st else torch.zeros_like(p)
                    for n in ("exp_avg", "exp_avg_sq") for p in params]
            step = int(st[params[0]]["step"]) if params[0] in st else 0
            pre = self.pack(params + moms + [model.active])
            out = map_step(model, opt, dstate, views, rgbs, depths, wts,
                           cfg, mcfg, *a, **kw)
            post = self.pack(params + [p.grad if p.grad is not None
                                       else torch.zeros_like(p)
                                       for p in params])
            self.map = dict(pre=pre, post=post, step=step,
                            likes=[p.detach() for p in params],
                            active=model.active.detach(), views=views,
                            rgbs=rgbs, depths=depths, wts=wts, cfg=cfg,
                            mcfg=mcfg, loss=out[0])
            return out

        self.slam.map_step = rec_map
        self.runner.track_frame = rec_track
        self.tap.install()

    def remove(self):
        self.slam.map_step, self.runner.track_frame = self.orig
        self.tap.remove()


def fields_of(snap, likes):
    vals = Recorder.unpack(snap, likes)
    return ref.gaussian_fields(*vals[:-1], vals[-1] > 0.5)


class SlamEntry(E.Entry):
    """``init_slam`` and the frames up to and including the first mapping
    round are set-up; the window tracks, keyframes and maps the frames
    after them, one by one.  Once the window has closed, the loop goes on
    with the recorder armed until it has made one ``track_frame`` and one
    ``map_step``, which the check redoes."""

    unit = "frames"

    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        sc = cfg["scene"]
        self.traj = self.views(mix["frames"])
        truth = scn.room(sc, self.seed, self.dev)
        self.rgbs, self.depths = self.targets(truth, self.traj,
                                              self.seed + 2)
        del truth
        P = self.P
        s = cfg["slam"]
        self.scfg = P["runner"].SLAMConfig(
            raster=self.raster_config(),
            tracking=P["slam"].TrackingConfig(**cfg["tracking"]),
            mapping=P["slam"].MappingConfig(**cfg["mapping"]), **s)
        self.cam_t = self.program_camera(self.t32(self.traj[0]))
        self.rec = Recorder(P["slam"], P["runner"])
        self.frame_idx = 0

    def frame(self, i):
        return self.P["slam"].Frame(self.rgbs[i], self.depths[i])

    def setup(self):
        runner = self.P["runner"]
        self.rec.install(self.faults)
        self.state = runner.init_slam(self.t32(self.traj[0]), self.frame(0),
                                      self.cam_t, self.scfg)
        self.frame_idx = 1
        while True:
            self.step()
            if (self.frame_idx - 1) % self.scfg.map_every == 0:
                break

    def step(self):
        i = self.frame_idx
        if i >= self.traj.shape[0]:
            # a run that reaches the sequence's end fails (readings)
            self.exhausted = True
            return
        self.state, _ = self.P["runner"].slam_step(
            self.state, self.frame(i), self.cam_t, self.scfg, i)
        self.frame_idx += 1

    def after_window(self):
        self.rec.armed = True
        while ((self.rec.track is None or self.rec.map is None)
               and not self.exhausted):
            self.step()
        self.rec.armed = False

    def release(self):
        self.rec.remove()
        del self.state

    def readings(self, tf32_control: bool = False):
        """The recorded ``track_frame``'s tracked pose (``pose_gap``) and
        first dual render (``jvp_gap``), and the recorded ``map_step``
        (``map_*``), each redone by the reference from the program's own
        state at that call, and each infinite where the call was not made
        (a tracker that renders nothing has no dual render); ``sequence_end``
        is 1 where the run ran out of frames."""
        out = dict(pose_gap=math.inf, jvp_gap=math.inf,
                   map_loss_gap=math.inf)
        t = self.rec.track
        if t is not None:
            f = fields_of(t["snap"], t["likes"])
            R = self.R._replace(tile_h=t["cfg"].tile_h,
                                tile_w=t["cfg"].tile_w)
            tc = E.tcfg_dict(dataclasses.asdict(t["tcfg"]))
            track = lambda tf32: ref.track(f, t["view0"], t["frame"].rgb,
                                           t["frame"].depth, self.cam, R,
                                           tc, tf32=tf32)
            got = track(True) if tf32_control else t["view"]
            out["pose_gap"] = E.pose_gap(got, track(False))
            if t["dual"] is not None:
                out["jvp_gap"] = E.jvp_gap(t["dual"], f, t["view0"],
                                           self.cam, R, tf32_control)
        if self.rec.map is not None:
            del out["map_loss_gap"]
            out.update(self._map_readings(tf32_control))
        out["sequence_end"] = float(self.exhausted)
        return out

    def _map_readings(self, tf32_control):
        m = self.rec.map
        likes = m["likes"]
        n = len(likes)
        pre = Recorder.unpack(m["pre"], likes + likes + likes
                              + [m["active"]])
        p0 = dict(zip(ref.FIELDS, pre[:n]))
        m0 = dict(zip(ref.FIELDS, pre[n:2 * n]))
        v0 = dict(zip(ref.FIELDS, pre[2 * n:3 * n]))
        active = pre[-1] > 0.5
        post = Recorder.unpack(m["post"], likes + likes)
        p1 = dict(zip(ref.FIELDS, post[:n]))
        g1 = dict(zip(ref.FIELDS, post[n:]))
        mc = dataclasses.asdict(m["mcfg"])
        R = self.R._replace(tile_h=m["cfg"].tile_h, tile_w=m["cfg"].tile_w)
        step = m["step"] + 1

        def ref_step(tf32):
            loss, g = ref.map_loss_and_grads(
                p0, active, m["views"], m["rgbs"], m["depths"], m["wts"],
                self.cam, R, mc["w_color"], mc["w_depth"], tf32=tf32)
            lrs = ref.map_lrs(mc, step)
            new = {k: ref.adam_update(p0[k], g[k], m0[k], v0[k], step,
                                      lrs[k])[0] for k in ref.FIELDS}
            return loss, g, new

        r_loss, r_g, r_new = ref_step(False)
        if tf32_control:
            loss, g, new = ref_step(True)
        else:
            loss, g, new = float(m["loss"]), g1, p1
        rgn = E.leaf_norms(r_g)
        ch = E.leaf_norms({k: new[k] - p0[k] for k in ref.FIELDS})
        rch = E.leaf_norms({k: r_new[k] - p0[k] for k in ref.FIELDS})
        return dict(map_loss_gap=E.rel_gap(loss, r_loss),
                    map_grad_gap=E.norm_gap(E.leaf_norms(g), rgn),
                    map_change_gap=E.norm_gap(ch, rch,
                                              skip=E.quiet_leaves(rgn)))


ENTRY = SlamEntry
