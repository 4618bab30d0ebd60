"""Shared arithmetic of the metric readers (``metrics/*.py``,
``endtoend/*.py``).  A reader that finds nothing to read returns None, and
the harness leaves its metric out of the line."""

from __future__ import annotations

import math

from . import trace, work


def rate(ctx):
    """Units completed over the whole window's seconds."""
    return ctx["units"] / ctx["window_s"] if ctx["window_s"] > 0 else None


def p95_ms(ctx):
    """The 95th percentile (nearest rank) of every request's latency in
    the window, in ms."""
    lat = sorted(ctx.get("latencies") or [])
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]


def busy_ms(ctx):
    prof = ctx.get("prof")
    if prof is None or prof.units == 0 or prof.busy_s <= 0:
        return None
    return 1e3 * prof.busy_s / prof.units


def idle_share(ctx):
    """100 x (1 - device busy time a unit under the profiler / host time a
    unit of the unprofiled window)."""
    b = busy_ms(ctx)
    if b is None or not ctx.get("host_s"):
        return None
    return 100.0 * (1.0 - b / (1e3 * ctx["host_s"]))


def roofline(ctx, piece: str, kernels: str):
    """100 x the least time of the work ``piece`` of a unit over the
    device time a unit of the kernels that do it (``kernels``, a regex
    over kernel names)."""
    prof, w = ctx.get("prof"), ctx.get("work")
    if prof is None or w is None:
        return None
    p = w.get(piece)
    t = trace.kernel_s(prof, kernels)
    if t <= 0 or p.ops + p.nbytes <= 0:
        return None
    return 100.0 * work.bound_s(p.ops, p.nbytes) / t


def step_roofline(ctx):
    """100 x the least time of a unit's whole counted work over its
    device busy time."""
    w, b = ctx.get("work"), busy_ms(ctx)
    if w is None or b is None:
        return None
    tot = w.total()
    if tot.ops + tot.nbytes <= 0:
        return None
    return 100.0 * work.bound_s(tot.ops, tot.nbytes) / (b * 1e-3)


def host_waits(ctx):
    return ctx.get("waits")


def launches(ctx):
    prof = ctx.get("prof")
    if prof is None or prof.units == 0:
        return None
    return trace.launches(prof)
