"""Device busy time a tracked frame: the union of CUDA activity under the
profiler."""

from splatbench import readers


def read(ctx):
    return readers.busy_ms(ctx)
