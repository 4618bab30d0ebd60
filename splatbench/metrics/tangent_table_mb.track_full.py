"""The megabytes of sorted tangent table that a tracked frame's dual
renders gather: the program's counter ``render.tangent_floats``, four
bytes a float, over the traced frames; a program that keeps no such
counter gives nothing."""

from splatbench.spans import snapshot


def read(ctx):
    prof = ctx.get("prof")
    if prof is None or not prof.units:
        return None
    c = (snapshot() or {}).get("counters") or {}
    if "render.tangent_floats" not in c:
        return None
    return 4e-6 * c["render.tangent_floats"] / prof.units
