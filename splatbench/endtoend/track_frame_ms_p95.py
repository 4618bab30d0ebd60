"""The 95th percentile of every tracked frame's latency in the window (host
clock, from the call to the card's last operation)."""

from splatbench import readers


def read(ctx):
    return readers.p95_ms(ctx)
