"""What the program records of itself: the counters of its
``utils.profiling`` (on only while the profiler records, so they hold
exactly the traced run's profiled stretch), read once that stretch has
ended.  Its spans' stream times are not read: under the profiler the
host holds every cell back, so a span's stream time is the profiled
host's time, not the device's work.

The module is found in ``sys.modules``, never imported here: ``entry.py``
stays the one place that imports the program.  A program that keeps no
such records, or a record that is missing, gives None, and the harness
leaves the metric out of the line.
"""

from __future__ import annotations

import sys

MODULE = "diff_gaussian_rasterization_tpu_torch.utils.profiling"


def snapshot():
    """The program's records (``snapshot()`` of its profiling module), or
    None where the program has none."""
    read = getattr(sys.modules.get(MODULE), "snapshot", None)
    return None if read is None else read()


def _counters(ctx):
    """The program's counters over the traced stretch, or None where there
    is no traced stretch or no record."""
    prof = ctx.get("prof")
    if prof is None or not prof.units:
        return None
    return (snapshot() or {}).get("counters")


def share(ctx, part: str, whole: str):
    """100 x the counter ``part`` over the counter ``whole``."""
    c = _counters(ctx) or {}
    if part not in c or not c.get(whole):
        return None
    return 100.0 * c[part] / c[whole]


def instance_fill(ctx):
    """100 x the instances that fit their render's slots over the slots
    sorted and walked, summed over the stretch's renders."""
    return share(ctx, "render.filled", "render.slots")
