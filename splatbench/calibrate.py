"""The readings that a cell's limits are set from, over many seeds in one
process: each seed's set-up and a short window at the cell's own size,
then the numbers the check compares for the program's timed path and for
the control (the reference computed with TF32 matrix products, put in the
program's place), both against the float32 reference.

    python3 -m splatbench.calibrate --workload replica-map \\
        --seconds 3 --seeds 11 12 13 [--control] [--fault half] \\
        [--only track_frame]

Prints one JSON line a seed on standard output.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from . import entry, faults
from .run import note, open_cell, pin_caches, window


def readings_for(name: str, seed: int, seconds: float, control: bool,
                 root: Path, device="cuda", overrides=None, faults=None):
    """``{"program": {...}, "control": {...}}`` for one seed (arguments
    as :func:`run.open_cell`'s)."""
    _, _, _, made = open_cell(name, seed, root, device, faults, overrides)
    made.setup()
    units, _ = window(made, seconds)
    made.after_window()
    made.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "units": units, "program": made.readings()}
    if control:
        out["control"] = made.readings(tf32_control=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=faults.KINDS,
                    help="plant this fault under the timed path")
    ap.add_argument("--only", choices=("map_step", "track_frame"),
                    help="plant the fault in this entry alone")
    args = ap.parse_args(argv)
    root = Path.cwd()
    pin_caches(root)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    for s in args.seeds:
        t0 = time.perf_counter()
        planted = None if args.fault is None else faults.faults(
            args.fault, entry.port()["slam"], args.only)
        r = readings_for(args.workload, s, args.seconds, args.control, root,
                         faults=planted)
        r["fault"] = args.fault
        r["seconds"] = time.perf_counter() - t0
        note(f"seed {s} done")
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
