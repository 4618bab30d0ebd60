"""A map step's counted work (work.py: blends, preprocess, binning, Adam):
its least time over the step's device busy time."""

from splatbench import readers


def read(ctx):
    return readers.step_roofline(ctx)
