"""Profiling helpers (PyTorch port of the JAX package's
``utils/profiling.py``): named ranges, a trace of everything in a block,
and the time of a callable with the device synchronized.

Beside them, what the profiling tools (``examples/prof*.py``) and
``chip_smoke.py`` read from ``torch.profiler``: the device-side events of
a profile (:func:`device_events`), the device's busy time against the
host clock (:func:`profile_run`, :func:`profile_breakdown`), the device
time and launches of each kernel a step (:func:`op_table`), and the
host's waits on the card (:func:`host_syncs`).  On a card they read the
CUDA activity only: a profile of a card that holds no device event is an
error for the tools (:func:`require_device_events`), never a reason to
read the host's events instead.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import Counter

import torch

annotate = torch.profiler.record_function  # with annotate("track_frame"):


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the host and, where there is one, the CUDA device for
    everything inside the block; the trace is written to ``logdir``
    (TensorBoard / Perfetto JSON)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def time_fn(fn, *args, iters: int = 10, warmup: int = 2):
    """Seconds per call of ``fn(*args)``: CUDA events around ``iters``
    calls on a machine with a card, the host clock otherwise."""
    for _ in range(warmup):
        fn(*args)
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


def device_us(e) -> float:
    """An averaged event's device time (us), whatever torch names it."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_events(prof):
    """The profile's device-side events (kernels, copies, fills): the
    operator-level ones repeat their time, and so do the device ranges of
    ``record_function`` annotations (``Optimizer.step#Adam.step``)."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def profile_run(fn, n=1, trace_path=None):
    """``torch.profiler`` over ``n`` calls of ``fn``, the host's activity
    and, where there is a card, the card's, synchronized at the end:
    ``(host-clock ms a call under the profiler, the profile)``;
    ``trace_path`` gets the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    sync = lambda: None
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        sync = torch.cuda.synchronize
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    return wall_ms / n, prof


def profile_breakdown(fn, n=3, top=12):
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler),
    and the device's busy share of the host-clock window: ``(host ms a
    call, device busy ms a call, the ``top`` kernels' lines)``, after one
    call outside the profile."""
    fn()
    wall_ms, prof = profile_run(fn, n)
    rows = sorted(device_events(prof), key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in rows) / 1e3
    lines = [f"{device_us(e) / 1e3 / n:9.4f} ms/call  x{e.count // n:<4d} "
             f"{e.key[:90]}" for e in rows[:top]]
    return wall_ms, busy_ms / n, lines


# the port's kernel functions (ops/kernels/csrc/*.cu), with their template
# arguments as the profiler names them: segment_sum_rows_kernel<2> and <12>
# are the two row widths
PORT_KERNEL = re.compile(
    r"\b(?:render_fwd|tile_scatter_sum|segment_sum|render_bwd|"
    r"segment_sum_rows(?:_any)?|render_jvp)_kernel(?:<[^>()]*>)?")


def op_table(events, n=1):
    """The per-op table of a profile's device events over ``n`` steps:
    ``(rows, total)``, each row ``{"name", "ms", "launches"}`` (device ms
    and launches a step, by kernel name, the longest first) and ``total``
    the device ms a step of every row."""
    rows = [dict(name=e.key, ms=device_us(e) / 1e3 / n,
                 launches=e.count / n) for e in events]
    rows.sort(key=lambda r: -r["ms"])
    return rows, sum(r["ms"] for r in rows)


def port_kernels(rows) -> dict:
    """The rows of :func:`op_table` that are the port's own kernels, by
    kernel function and template arguments (``render_fwd_kernel<4, false,
    false>``): ``{name: {"ms", "launches"}}`` a step, summed over rows
    of one name."""
    out = {}
    for r in rows:
        m = PORT_KERNEL.search(r["name"])
        if m:
            k = out.setdefault(m.group(0), {"ms": 0.0, "launches": 0.0})
            k["ms"] += r["ms"]
            k["launches"] += r["launches"]
    return out


def require_device_events(events, device):
    """A profile on a card must hold CUDA activity: ``RuntimeError``
    otherwise (the tools never read the host's events as the device's)."""
    if torch.device(device).type == "cuda" and not events:
        raise RuntimeError("torch.profiler recorded no CUDA activity on the "
                           "card: device times not measured")


def host_syncs(fn, n=1):
    """The host's waits on the card in ``fn()``, ``n`` units of work: every
    synchronizing CUDA call warns in the sync debug mode.  Returns the
    count a unit and the ten busiest call sites (file:line, count a
    unit)."""
    import warnings
    sites = Counter()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for w in caught:
        if "synchroniz" in str(w.message):
            sites[f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"] += 1
    return (sum(sites.values()) / n,
            {k: v / n for k, v in sites.most_common(10)})
