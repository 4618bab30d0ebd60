"""100 x (1 - device busy time a map step under the profiler / host time a
step in the unprofiled window of the same run)."""

from splatbench import readers


def read(ctx):
    return readers.idle_share(ctx)
