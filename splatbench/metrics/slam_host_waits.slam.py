"""Host waits on the card a SLAM frame (the sync debug mode's warnings)."""

from splatbench import readers


def read(ctx):
    return readers.host_waits(ctx)
