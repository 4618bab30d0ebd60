"""The dual blends of a tracked frame (the render and six pose tangents)
and their per-instance sums: their least time over the device time of
the kernels that do that work (render_jvp with its culling boxes,
tile_scatter_sum)."""

from splatbench import readers

KERNELS = "|".join([
    r"render_jvp_kernel",
    r"tile_scatter_sum_kernel",
    r"cull_boxes_kernel",
])


def read(ctx):
    return readers.roofline(ctx, "render_jvp", KERNELS)
