"""``render_jvp_roofline.track``'s reader under the Full variant's cell's
name: the same kernels over the same piece of the entry's counted work,
which ``TrackFullEntry.work`` counts at the full pose chain's PER_K
(``work_full.blend_jvp_full``: PER_K = 9 with the SH colour branch)."""

from splatbench import cells


def read(ctx):
    return cells.metric_reader("render_jvp_roofline.track").read(ctx)
