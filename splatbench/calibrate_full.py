"""``calibrate.py`` for the Full variant's cells: the readings that their
limits are set from, over many seeds in one process, with the faults of
``faults_full.py`` besides those of ``faults.py`` (planted in the tracker),
and the colour branch's share of the pose Jacobian.

    python3 -m splatbench.calibrate_full --workload replica-track-full \\
        --seconds 5 --seeds 11 12 13 [--control] [--fault no_colour] \\
        [--share 2]

Prints one JSON line a seed on standard output.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import calibrate, entry, faults, faults_full
from .run import note, open_cell, pin_caches


def planted(kind):
    """The tracker's fault ``kind`` (``faults.py``'s or
    ``faults_full.py``'s), None for none."""
    if kind is None:
        return None
    slam = entry.port()["slam"]
    if kind in faults_full.KINDS:
        return faults_full.faults(kind, slam)
    return faults.faults(kind, slam, "track_frame")


def colour_share(name: str, seed: int, views: int, root: Path,
                 device="cuda") -> float:
    """The colour branch's share of the pose Jacobian over the cell's
    first ``views`` start views (``TrackFullEntry.colour_share``)."""
    return open_cell(name, seed, root, device)[3].colour_share(views)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=faults.KINDS + faults_full.KINDS)
    ap.add_argument("--share", type=int, default=0,
                    help="views of the colour share (0: none)")
    args = ap.parse_args(argv)
    root = Path.cwd()
    pin_caches(root)
    if not torch.cuda.is_available():
        print("calibrate_full: no CUDA card", file=sys.stderr)
        return 3
    for s in args.seeds:
        t0 = time.perf_counter()
        r = calibrate.readings_for(args.workload, s, args.seconds,
                                   args.control, root,
                                   faults=planted(args.fault))
        r["fault"] = args.fault
        if args.share:
            r["colour_share"] = colour_share(args.workload, s, args.share,
                                             root)
        r["seconds"] = time.perf_counter() - t0
        note(f"seed {s} done")
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
