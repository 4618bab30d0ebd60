"""Kernel launches a SLAM frame (the profiled stretch)."""

from splatbench import readers


def read(ctx):
    return readers.launches(ctx)
