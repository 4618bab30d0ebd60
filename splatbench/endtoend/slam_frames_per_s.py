"""SLAM frames completed over the window, which ends at the first frame
boundary after the run's seconds."""

from splatbench import readers


def read(ctx):
    return readers.rate(ctx)
