"""A tracked frame's counted work (work.py: dual blends, preprocess and its
tangents, binning): its least time over the frame's device busy time."""

from splatbench import readers


def read(ctx):
    return readers.step_roofline(ctx)
