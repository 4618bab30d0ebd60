"""``track_frame`` as ``track_frame.py`` drives it, with the instance
budget's scale taken from the mix (key ``raster_budget_scale``) where the
configuration states none, as the SLAM loop's configurations do (their
loop sizes its budget itself), and the work of a tracker with a line
search and fresh binning counted."""

from splatbench import work as W
from splatbench.entries.track_frame import TrackEntry


class TrackBudgetEntry(TrackEntry):
    """:class:`TrackEntry` with the mix's budget scale."""

    def __init__(self, cfg, mix, seed, device):
        if "raster_budget_scale" not in cfg:
            cfg = dict(cfg, raster_budget_scale=mix["raster_budget_scale"])
        super().__init__(cfg, mix, seed, device)

    def work(self) -> W.Work:
        """A tracked frame as ``_track_gn`` runs it: per pyramid level and
        Gauss-Newton iteration one dual render (the render and six
        tangents, with the preprocess and its six forward-mode tangents);
        with the line search, one forward render (``render_fwd`` and a
        preprocess) an iteration and one more at the level's end; with
        fresh binning a binning a render, else one a level with its
        preprocess.  The pool's mean counts at the start poses."""
        t = self.cfg["tracking"]
        levels = [(2 ** lv, t.get("coarse_iters", 5))
                  for lv in range(max(t.get("pyramid", 1), 1) - 1, 0, -1)]
        levels.append((1, t.get("iters", 12)))
        p = int(self.fields["active"].numel())
        frozen = bool(t.get("freeze_binning", False))
        pieces = dict(render_jvp=W.ZERO, render_fwd=W.ZERO,
                      preprocess=W.ZERO, binning=W.ZERO)
        for s, iters in levels:
            cam = self.cam.scaled(s)
            counts = W.pool_counts(self.fields, self.view0, cam, self.R)
            inst = sum(c[0] for c in counts) / len(counts)
            contrib = sum(c[1] for c in counts) / len(counts)
            px, tiles = cam.height * cam.width, W.tiles(cam, self.R)
            costs = iters + 1 if t.get("line_search", False) else 0
            pieces["render_jvp"] += W.blend_jvp(
                inst, contrib, px, tiles).scaled(iters)
            pieces["render_fwd"] += W.blend_fwd(
                inst, contrib, px, tiles).scaled(costs)
            pieces["preprocess"] += W.preprocess(p).scaled(
                7 * iters + costs + int(frozen))
            pieces["binning"] += W.binning(inst).scaled(
                1 if frozen else iters + costs)
        return W.Work(pieces)


ENTRY = TrackBudgetEntry
