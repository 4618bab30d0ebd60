"""The backward blend and its per-Gaussian sums of a map step: their least
time over the device time of the kernels that do that work (render_bwd,
segment_sum_rows with twelve columns)."""

from splatbench import readers

KERNELS = "|".join([
    r"render_bwd_kernel",
    r"segment_sum_rows_kernel<12>",
    r"pixel_map_kernel",
])


def read(ctx):
    return readers.roofline(ctx, "render_bwd", KERNELS)
