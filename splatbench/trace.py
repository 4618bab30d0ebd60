"""What the traced run reads from ``torch.profiler`` and from the sync
debug mode: device busy time (the union of CUDA activity), device time
and launches by kernel, idle gaps by what the host was doing, and the
host's waits on the card.

The arithmetic of busy time, kernel tables and host waits is a copy of
the program's ``utils/profiling.py`` (``device_events``, ``op_table``,
``host_syncs``), read here from the profiler's Chrome trace, whose event
format does not change between PyTorch versions.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
import warnings
from collections import Counter
from typing import NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
SPAN = "splatbench."
SCAN = 256               # host ops looked at before a gap's middle


class Profile(NamedTuple):
    """A profiled stretch of ``units`` units of work."""

    units: int
    window_s: float           # host clock over the stretch
    busy_s: float             # union of device activity
    kernels: dict             # name -> device seconds over the stretch
    launches: dict            # name -> launches over the stretch
    gaps: list                # [(host op, idle seconds)], longest first


def union_s(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(device, host, t0, t1):
    """The device's idle stretches within ``[t0, t1]`` (microseconds), each
    named by the innermost host op that covers its middle ("python" where
    none does): ``[(name, seconds)]`` summed by name, longest first."""
    busy = sorted(device)
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    by = Counter()
    host = sorted(host, key=lambda h: h[0])
    starts = [h[0] for h in host]
    for s, e in gaps:
        mid = 0.5 * (s + e)
        best = None
        # the innermost op covering the middle starts shortly before it
        for j in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 1 - SCAN),
                       -1):
            hs, he, name = host[j]
            if he >= mid and (best is None or he - hs < best[0]):
                best = (he - hs, name)
        by[best[1] if best else "python"] += (e - s) * 1e-6
    return by.most_common()


def read_chrome(path: str, units: int, window_s: float) -> Profile:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host, kern, launch = [], [], Counter(), Counter()
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            kern[e["name"]] += d * 1e-6
            if cat == "kernel":
                launch[e["name"]] += 1
        elif cat in HOST_CATS:
            host.append((s, s + d, e["name"]))
    spans = [h for h in host if h[2].startswith(SPAN)]
    lo = min((h[0] for h in spans), default=min((d[0] for d in dev),
                                                default=0.0))
    hi = max((h[1] for h in spans), default=max((d[1] for d in dev),
                                                default=0.0))
    return Profile(units, window_s, union_s(dev) * 1e-6, dict(kern),
                   dict(launch), idle_gaps(dev, host, lo, hi))


def profile(step, units: int, span: str) -> Profile:
    """``units`` calls of ``step`` under ``torch.profiler`` (host ops and
    CUDA activity), each inside a ``record_function`` span; the trace is
    read from a Chrome trace in the temporary directory and deleted."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            with torch.profiler.record_function(SPAN + span):
                step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome(path, units, window_s)
    finally:
        os.unlink(path)


def host_waits(step, units: int):
    """The host's waits on the card over ``units`` calls of ``step``: every
    synchronizing CUDA call warns in the sync debug mode.  Returns the
    count a unit and the busiest call sites."""
    sites = Counter()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(units):
                step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for w in caught:
        if "synchroniz" in str(w.message):
            sites[f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"] += 1
    return (sum(sites.values()) / units,
            {k: v / units for k, v in sites.most_common(10)})


def kernel_s(prof: Profile, pattern: str) -> float:
    """Device seconds a unit of the kernels whose names match
    ``pattern``."""
    rx = re.compile(pattern)
    return sum(s for k, s in prof.kernels.items() if rx.search(k)) \
        / prof.units


def launches(prof: Profile) -> float:
    return sum(prof.launches.values()) / prof.units
