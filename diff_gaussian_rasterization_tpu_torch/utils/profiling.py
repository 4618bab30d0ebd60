"""Profiling helpers (PyTorch port of the JAX package's
``utils/profiling.py``): named ranges, a trace of everything in a block,
and the time of a callable with the device synchronized.
"""

from __future__ import annotations

import contextlib
import time

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
