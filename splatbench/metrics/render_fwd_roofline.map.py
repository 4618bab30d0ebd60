"""The forward blend and its per-instance and per-Gaussian sums of a map
step: their least time over the device time of the kernels that do that
work (render_fwd, tile_scatter_sum, segment_sum_rows with two columns)."""

from splatbench import readers

KERNELS = "|".join([
    r"render_fwd_kernel",
    r"tile_scatter_sum_kernel",
    r"segment_sum_rows_kernel<2>",
])


def read(ctx):
    return readers.roofline(ctx, "render_fwd", KERNELS)
