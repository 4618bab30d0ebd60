"""``map_step`` over keyframe windows of a pool of walkthrough keyframes,
closed loop, back to back (mix keys: ``pool``, ``pool_stride``,
``window``, ``setup_steps``, ``schedule``)."""

import numpy as np
import torch

from splatbench import entry as E
from splatbench import reference as ref
from splatbench import scene as scn
from splatbench import work as W


def balanced_windows(pool: int, window: int, steps: int, seed: int):
    """[steps, window] keyframe indices, in blocks of ``pool`` steps: in a
    block each keyframe is the newest once (a seeded permutation) and one
    of the others ``window - 1`` times (the permutation shifted by
    ``window - 1`` distinct seeded offsets), so every block asks for the
    same renders whatever the seed, in another order."""
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(-(-steps // pool)):
        perm = rng.permutation(pool)
        shifts = rng.choice(np.arange(1, pool), window - 1, replace=False)
        blocks.append(np.stack([perm] + [np.roll(perm, -int(t))
                                         for t in shifts], 1))
    return np.concatenate(blocks)[:steps]


class MapEntry(E.Entry):
    """In the balanced seeded order of :func:`balanced_windows`.  Set-up
    makes ``setup_steps`` steps through the same call; the reference
    follows them from the benchmark's own start map."""

    unit = "steps"

    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        sc = cfg["scene"]
        traj = self.views(mix["pool"] * mix["pool_stride"])
        self.pool64 = traj[::mix["pool_stride"]][:mix["pool"]]
        truth = scn.room(sc, self.seed, self.dev)
        self.rgbs, self.depths = self.targets(truth, self.pool64,
                                              self.seed + 2)
        del truth
        self.pool = self.t32(self.pool64)
        self.map0 = scn.perturbed(scn.room(sc, self.seed, self.dev), sc,
                                  self.seed)
        self.max_instances, self.instances = self.budget(self.map0,
                                                         self.pool)
        self.rcfg = self.raster_config(max_instances=self.max_instances)
        slam = self.P["slam"]
        self.mcfg = slam.MappingConfig(**cfg["mapping"])
        self.model = self.model_of(self.map0)
        self.opt = slam.make_map_optimizer(self.model, self.mcfg)
        self.dstate = self.P["gaussians"].DensifyState.zero(
            self.model.capacity, device=self.dev)
        self.schedule = balanced_windows(mix["pool"], mix["window"],
                                         mix["schedule"], self.seed)
        self.sched_dev = torch.as_tensor(self.schedule, device=self.dev)
        self.wts = torch.ones(mix["window"], device=self.dev)
        self.steps = 0
        self.losses = []

    def step(self):
        idx = self.sched_dev[self.steps % self.schedule.shape[0]]
        self.steps += 1
        map_fn = self.faults.get("map_step", self.P["slam"].map_step)
        loss, self.dstate, _ = map_fn(
            self.model, self.opt, self.dstate, self.pool[idx],
            self.rgbs[idx], self.depths[idx], self.wts, self.rcfg,
            self.mcfg, self.cam.height, self.cam.width, self.cam.tanfovx,
            self.cam.tanfovy, int(idx.shape[0]))
        return loss

    def setup(self):
        """The first ``setup_steps`` steps, with what the check reads:
        each step's loss, the first gradient as Adam holds it after step
        1, and the parameters after the last."""
        b1 = self.opt.adam.param_groups[0]["betas"][0]
        for i in range(self.mix["setup_steps"]):
            self.losses.append(self.step())
            if i == 0:
                st = self.opt.adam.state
                self.g1 = {k: (st[p]["exp_avg"] / (1 - b1)).clone()
                           if p in st else torch.zeros_like(p)
                           for k, p in self.params().items()}
        self.p_set = {k: p.detach().clone()
                      for k, p in self.params().items()}
        self.losses = [float(x) for x in self.losses]

    def params(self):
        return {k: getattr(self.model, k) for k in ref.FIELDS}

    def release(self):
        del self.model, self.opt, self.dstate

    def reference_steps(self, tf32: bool):
        """The reference's losses, first gradient and parameters after the
        set-up's steps, from the benchmark's own start map."""
        p = {k: self.map0[k].clone() for k in ref.FIELDS}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v = {k: torch.zeros_like(x) for k, x in p.items()}
        mc = self.cfg["mapping"]
        losses, g1 = [], None
        for s in range(self.mix["setup_steps"]):
            idx = torch.as_tensor(self.schedule[s], device=self.dev)
            loss, g = ref.map_loss_and_grads(
                p, self.map0["active"], self.pool[idx], self.rgbs[idx],
                self.depths[idx], self.wts, self.cam, self.R,
                mc["w_color"], mc["w_depth"], tf32=tf32)
            losses.append(loss)
            g1 = g if g1 is None else g1
            lrs = ref.map_lrs(mc, s + 1)
            for k in ref.FIELDS:
                p[k], m[k], v[k] = ref.adam_update(p[k], g[k], m[k], v[k],
                                                   s + 1, lrs[k])
        return losses, g1, p

    def compare(self, losses, g1, p_end, r_losses, r_g1, r_p_end):
        rgn = E.leaf_norms(r_g1)
        ch = E.leaf_norms({k: p_end[k] - self.map0[k] for k in ref.FIELDS})
        rch = E.leaf_norms({k: r_p_end[k] - self.map0[k]
                            for k in ref.FIELDS})
        return dict(
            loss_gap=max(E.rel_gap(a, b) for a, b in zip(losses, r_losses)),
            grad_gap=E.norm_gap(E.leaf_norms(g1), rgn),
            change_gap=E.norm_gap(ch, rch, skip=E.quiet_leaves(rgn)))

    def readings(self, tf32_control: bool = False):
        r_losses, r_g1, r_p = self.reference_steps(tf32=False)
        if tf32_control:
            c_losses, c_g1, c_p = self.reference_steps(tf32=True)
            return self.compare(c_losses, c_g1, c_p, r_losses, r_g1, r_p)
        return self.compare(self.losses, self.g1, self.p_set, r_losses,
                            r_g1, r_p)

    def work(self) -> W.Work:
        """A step: for each of its keyframes the preprocess, binning,
        forward and backward blends and the preprocess's backward, then
        Adam; keyframes counted as the pool's mean (the schedule draws
        each pool keyframe alike) on the start map."""
        counts = W.pool_counts(self.map0, self.pool, self.cam, self.R)
        px = self.cam.height * self.cam.width
        tiles = W.tiles(self.cam, self.R)
        p = int(self.map0["active"].numel())
        n_kf = self.mix["window"]
        inst = sum(c[0] for c in counts) / len(counts)
        contrib = sum(c[1] for c in counts) / len(counts)
        n_par = sum(int(self.map0[k].numel()) for k in ref.FIELDS)
        return W.Work(dict(
            render_fwd=W.blend_fwd(inst, contrib, px, tiles).scaled(n_kf),
            render_bwd=W.blend_bwd(inst, contrib, px, tiles,
                                   p).scaled(n_kf),
            preprocess=(W.preprocess(p)
                        + W.preprocess(p, True)).scaled(n_kf),
            binning=W.binning(inst).scaled(n_kf), adam=W.adam(n_par)))


ENTRY = MapEntry
