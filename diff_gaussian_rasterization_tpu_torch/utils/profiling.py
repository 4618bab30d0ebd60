"""The program's tracing, and what the profiling tools read from
``torch.profiler``.

Tracing: :func:`span` marks a layer boundary of the program
(``with span("render.preprocess"):``) and :func:`count` a count of its
work.  Both are off, and cost one check, unless ``torch.profiler`` is
recording or the call is inside :func:`recording`.  On, a span opens a
``record_function`` range named ``"dgr." + name`` (so every profiler
trace carries it, on the clock of the CUDA activity), reads the host
clock at entry and exit, records a pair of timing CUDA events on the
current stream where CUDA is in use, and keeps the span that was open
when it began as its parent (a span that the autograd engine's thread
opens inside a backward is the child of the span open on the calling
thread).  Records stay in memory, aggregated by name; :func:`snapshot`
resolves them (one ``synchronize``) and :func:`reset` clears them.  A
counter takes host numbers and 0-dim device tensors that the program
already holds; a device value is copied, without a wait, into a page of
pinned host memory and summed once the copy has landed, so counting
never waits on the card and keeps none of the program's tensors alive
(:func:`count_true` counts a mask's true entries with one elementwise
add).  The records' memory is bounded: spans are aggregated by name, the
pages and events are reused once read.

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
import functools
import re
import time
from collections import Counter, defaultdict

import torch

PREFIX = "dgr."   # of every span's record_function range

_AUTOGRAD_PROFILER = torch.autograd.profiler
if hasattr(_AUTOGRAD_PROFILER, "_is_profiler_enabled"):
    def _profiler_on() -> bool:
        return _AUTOGRAD_PROFILER._is_profiler_enabled
else:
    _profiler_on = torch._C._autograd._profiler_enabled

NULL = contextlib.nullcontext()   # the one span of tracing off
_recording = 0                    # depth of recording() blocks
_open = []                        # the open spans, innermost last
_pending = []                     # closed spans whose events are unread
_free = []                        # timing events read and free for reuse
FOLD = 512                        # closed spans kept before a fold
_spans = {}                       # name -> aggregate
_sums = defaultdict(int)          # counter name -> the values read so far
PAGE = 1024                       # device values a page of pinned memory
_pages = {}                       # dtype -> the page being filled
_landing = []                     # filled pages whose copies may be unread
_spare = defaultdict(list)        # dtype -> read pages free for reuse
_masks = {}                       # (name, shape, device) -> accumulator


def tracing() -> bool:
    """Whether spans and counters record: the profiler is recording, or
    the call is inside :func:`recording`."""
    return _recording > 0 or _profiler_on()


@contextlib.contextmanager
def recording():
    """Tracing on inside the block, with no profiler running."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


class _Agg:
    __slots__ = ("calls", "host_s", "host_self_s", "stream_s",
                 "stream_self_s", "parents")

    def __init__(self):
        self.calls, self.host_s, self.host_self_s = 0, 0.0, 0.0
        self.stream_s = self.stream_self_s = None
        self.parents = Counter()

    def row(self) -> dict:
        return dict(calls=self.calls, host_s=self.host_s,
                    host_self_s=self.host_self_s, stream_s=self.stream_s,
                    stream_self_s=self.stream_self_s,
                    parents=dict(self.parents))


class _Span:
    __slots__ = ("name", "parent", "range", "t0", "events", "child_host",
                 "child_stream")

    def __init__(self, name: str):
        self.name = name
        self.child_host, self.child_stream = 0.0, 0.0

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (_event(), _event())
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        _open.remove(self)
        agg = _spans.get(self.name)
        if agg is None:
            agg = _spans[self.name] = _Agg()
        agg.calls += 1
        agg.host_s += host
        agg.host_self_s += host - self.child_host
        if self.parent is not None:
            self.parent.child_host += host
            agg.parents[self.parent.name] += 1
        if self.events is not None:
            _pending.append(self)
            if len(_pending) >= FOLD:
                _fold(wait=False)
        return False


def _event():
    return _free.pop() if _free else torch.cuda.Event(enable_timing=True)


def span(name: str):
    """A span of the program named ``name`` (see the module's docstring):
    with tracing off, the shared null context :data:`NULL`."""
    if not (_recording or _profiler_on()):
        return NULL
    return _Span(name)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Page:
    """Pinned host slots for device values, each with its counter's name
    and cap, and the event recorded once the page is full."""
    __slots__ = ("buf", "keys", "done")

    def __init__(self, dtype):
        self.buf = torch.empty(PAGE, dtype=dtype, pin_memory=True)
        self.keys = []
        self.done = None


def _add(name: str, v, cap):
    _sums[name] += v if cap is None else min(v, cap)


def count(name: str, value, cap: int = None):
    """Add ``value`` (a host number, or a 0-dim device tensor the program
    holds) to the counter ``name``, tracing on only; with ``cap``,
    ``min(value, cap)`` is added.  A CUDA value is copied to a pinned
    page on the current stream (``non_blocking``: no wait, no kernel) and
    read once its page's copies have landed.  Read by :func:`snapshot`."""
    if not (_recording or _profiler_on()):
        return
    if not (torch.is_tensor(value) and value.is_cuda):
        _add(name, value.item() if torch.is_tensor(value) else value, cap)
        return
    page = _pages.get(value.dtype)
    if page is None:
        spare = _spare[value.dtype]
        page = _pages[value.dtype] = (spare.pop() if spare
                                      else _Page(value.dtype))
    page.buf[len(page.keys)].copy_(value, non_blocking=True)
    page.keys.append((name, cap))
    if len(page.keys) == PAGE:
        page.done = torch.cuda.Event()
        page.done.record()
        _landing.append(_pages.pop(value.dtype))
        _read_pages(wait=False)


def count_true(name: str, mask, times: int = 1):
    """Add ``times`` x the true entries of the device mask ``mask`` to the
    counter ``name``, tracing on only: one elementwise kernel a call (the
    accumulator of the mask's shape made by the first, added to by the
    rest), reduced when read.  A bool ``sum`` would cast first: two
    launches."""
    if _recording or _profiler_on():
        key = (name, tuple(mask.shape), mask.device)
        acc = _masks.get(key)
        if acc is None:
            _masks[key] = mask * times
        else:
            acc.add_(mask, alpha=times)


def _read(page: _Page):
    for (name, cap), v in zip(page.keys, page.buf.tolist()):
        _add(name, v, cap)
    page.keys.clear()


def _read_pages(wait: bool):
    """Sum the filled pages whose copies have landed (all of them after a
    ``synchronize``: ``wait``), oldest first, and keep them for reuse."""
    n = 0
    for page in _landing:
        if not (wait or page.done.query()):
            break
        _read(page)
        _spare[page.buf.dtype].append(page)
        n += 1
    del _landing[:n]


def _fold(wait: bool):
    """Fold the closed spans' stream times into the aggregates, oldest
    first, and free their events for reuse: all of them after a
    ``synchronize`` (``wait``), else those whose last event the device has
    passed, with no wait.  Children close before their parents, so each
    parent has its children's stream time when its turn comes; a bounded
    set of live events keeps recording them cheap."""
    n = 0
    for s in _pending:
        if not (wait or s.events[1].query()):
            break
        t = s.events[0].elapsed_time(s.events[1]) * 1e-3
        agg = _spans[s.name]
        agg.stream_s = (agg.stream_s or 0.0) + t
        agg.stream_self_s = (agg.stream_self_s or 0.0) + t - s.child_stream
        if s.parent is not None:
            s.parent.child_stream += t
        _free.extend(s.events)
        n += 1
    del _pending[:n]


def snapshot() -> dict:
    """``{"spans": {name: {calls, host_s, host_self_s, stream_s,
    stream_self_s, parents}}, "counters": {name: value}}`` of everything
    recorded since the last :func:`reset`, in seconds.  Self time is the
    span's time less its children's; ``parents`` counts the calls by the
    enclosing span's name (a top-level call counts in none); the stream
    times of a span that never ran with CUDA in use are None (not
    measured).  Waits once for the card, then reads the events and the
    counters."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _fold(wait=True)
    _read_pages(wait=True)
    for page in _pages.values():
        _read(page)
    counters = dict(_sums)
    for (name, _, _), acc in _masks.items():
        counters[name] = counters.get(name, 0) + int(acc.sum())
    return dict(spans={k: a.row() for k, a in _spans.items()},
                counters=counters)


def reset():
    """Clear every record (spans still open keep running)."""
    _pending.clear()
    _spans.clear()
    _sums.clear()
    _pages.clear()
    _landing.clear()
    _masks.clear()


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
    r"\b(?:render_fwd|tile_scatter_sum|render_bwd|"
    r"segment_sum_rows(?:_any)?|render_jvp|preprocess_fwd|preprocess_bwd|"
    r"preprocess_view|twist_tangents|gn_reduce)_kernel(?:<[^>()]*>)?")


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
