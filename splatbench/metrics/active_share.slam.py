"""The active share of the slots that the map steps preprocess, over a SLAM
frame's map steps (%): the program's counters ``map.active`` over
``map.gaussians``."""

from splatbench import spans


def read(ctx):
    return spans.share(ctx, "map.active", "map.gaussians")
