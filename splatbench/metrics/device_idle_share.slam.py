"""100 x (1 - device busy time a SLAM frame under the profiler / host time
a frame in the unprofiled window of the same run)."""

from splatbench import readers


def read(ctx):
    return readers.idle_share(ctx)
