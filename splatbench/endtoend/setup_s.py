"""Process start to the first timed step: kernel build or load, scene,
targets, program set-up and warm-up."""

from splatbench import readers


def read(ctx):
    return ctx["setup_s"]
