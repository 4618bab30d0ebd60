"""Map steps completed over the whole window's seconds."""

from splatbench import readers


def read(ctx):
    return readers.rate(ctx)
