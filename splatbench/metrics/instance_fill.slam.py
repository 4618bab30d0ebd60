"""The share of the sorted and walked instance slots that hold an
instance, over every render of a SLAM frame (%): the program's counters
``render.filled`` over ``render.slots``."""

from splatbench import spans


def read(ctx):
    return spans.instance_fill(ctx)
