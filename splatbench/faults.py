"""Faults planted under the timed path, to show that the check catches
them (``tests/``, ``calibrate.py --fault``): each replaces one of the
program's entries with a broken version of it.

- ``unchanged``: the step returns its state unchanged (a map step that
  updates nothing; a tracker that returns its start pose);
- ``half``: half of the keyframe window left out, the loss the mean over
  the rest;
- ``altered``: the answer altered where it is produced (the map step's
  means moved by 1e-3 after the step; the tracked pose moved 1 cm along
  x).
"""

from __future__ import annotations

import torch

KINDS = ("unchanged", "half", "altered")


def faults(kind: str, port_slam, only: str = None) -> dict:
    """``{entry name: broken function}`` for the fault ``kind``, in the
    entry ``only`` alone where it is given."""
    broken = _faults(kind, port_slam)
    return broken if only is None else {only: broken[only]}


def _faults(kind: str, port_slam) -> dict:
    map_step, track_frame = port_slam.map_step, port_slam.track_frame
    if kind == "unchanged":
        def broken_map(model, opt, dstate, *a, **kw):
            return torch.zeros((), device=model.means3D.device), dstate, \
                (None, None)

        def broken_track(model, view0, frame, cfg, tcfg, cam_t, **kw):
            v = view0.detach().clone()
            return v, torch.zeros((), device=v.device), \
                torch.zeros(0, device=v.device)
        return dict(map_step=broken_map, track_frame=broken_track)
    if kind == "half":
        def broken_map(model, opt, dstate, views, rgbs, depths, wts, cfg,
                       mcfg, h, w, tx, ty, n_frames, **kw):
            k = max(1, n_frames // 2)
            return map_step(model, opt, dstate, views[:k], rgbs[:k],
                            depths[:k], wts[:k], cfg, mcfg, h, w, tx, ty, k,
                            **kw)
        return dict(map_step=broken_map)
    if kind == "altered":
        def broken_map(model, *a, **kw):
            out = map_step(model, *a, **kw)
            with torch.no_grad():
                model.means3D.add_(1e-3)
            return out

        def broken_track(*a, **kw):
            view, cost, costs = track_frame(*a, **kw)
            view = view.clone()
            view[3, 0] += 1e-2
            return view, cost, costs
        return dict(map_step=broken_map, track_frame=broken_track)
    raise KeyError(f"unknown fault {kind!r}")
