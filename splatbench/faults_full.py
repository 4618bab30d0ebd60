"""Faults of the Full variant's tracker, planted under the timed path to
show that the check of ``replica-track-full`` catches them (``tests/``,
``calibrate_full.py``), beside ``faults.py``'s.  Each replaces the
program's ``track_frame`` with one that tracks with a branch of the pose
chain turned off in the configuration it is given:

- ``no_colour``: the SH colour branch dropped (``pose_sh_branch`` off),
  what the dual render did before it carried colour tangents;
- ``no_sigma2d``: the Σ2D branch dropped (``pose_cov2d_branch`` off).

The image the tracker fits is unchanged; only its Jacobian loses a
branch.
"""

from __future__ import annotations

KINDS = ("no_colour", "no_sigma2d")
OFF = {"no_colour": "pose_sh_branch", "no_sigma2d": "pose_cov2d_branch"}


def faults(kind: str, port_slam) -> dict:
    """``{"track_frame": broken function}`` for the fault ``kind``."""
    if kind not in OFF:
        raise KeyError(f"unknown fault {kind!r}")
    track_frame, flag = port_slam.track_frame, OFF[kind]

    def broken_track(model, view0, frame, cfg, *a, **kw):
        return track_frame(model, view0, frame, cfg.replace(**{flag: False}),
                           *a, **kw)
    return dict(track_frame=broken_track)
