"""Deterministic per-Gaussian reduction of the backward's gradient rows.

Port of the JAX package's ``ops/kernels/segment_sum.py`` (the TPU kernel
``_kernel``, driven by ``segment_sum_rows``).  In pre-sort (Gaussian-major)
instance order every Gaussian's instances form one contiguous run
``[gauss_start[p], gauss_stop[p])``, and ``inv`` maps that order to the
sorted positions where the backward core wrote its rows.  So

    out[p, c] = sum of rows[inv[j], c] for j in [gauss_start[p], gauss_stop[p])

taken in order of j: bit-reproducible from run to run, where a scatter
with float atomics is not.  On the TPU this was a one-hot matrix product;
on a CUDA tensor it is the ``segment_sum_rows`` kernel of
``csrc/render_bwd.cu`` (one warp per 32 consecutive Gaussians walking the
span of their runs 32 entries at a time, the gather through ``inv`` fused
in, 12-float rows as three 16-byte vectors); on a CPU tensor the plain version, ``index_add_`` over
the gathered rows, which adds in input order there and so equals the
kernel bit for bit.

The render op uses it twice: for the backward's gradient rows (F = 12) and
for the per-Gaussian uncertainty sums (F = 2: each instance's ``u_inst``
and its pixel count, exact in float32 below 2**24).
"""

from __future__ import annotations

import torch

from .render import _check_cuda, launches, row_launches


def runs(gauss_start, gauss_stop):
    """(Gaussian id, pre-sort index) of every instance in a run, in order."""
    lengths = (gauss_stop - gauss_start).to(torch.int64)
    p = gauss_start.shape[0]
    seg = torch.repeat_interleave(
        torch.arange(p, device=gauss_start.device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    j = gauss_start.to(torch.int64)[seg] + (
        torch.arange(seg.shape[0], device=seg.device) - first[seg])
    return seg, j


def segment_sum_rows_reference(rows, inv, gauss_start, gauss_stop):
    """Plain version of :func:`segment_sum_rows`: ``index_add_`` of the rows
    gathered through ``inv`` (in input order on the CPU; with atomics, in
    no fixed order, on the card)."""
    seg, j = runs(gauss_start, gauss_stop)
    out = torch.zeros((gauss_start.shape[0], rows.shape[1]),
                      dtype=rows.dtype, device=rows.device)
    out.index_add_(0, seg, rows[inv.to(torch.int64)[j]])
    return out


def segment_sum_rows(rows, inv, gauss_start, gauss_stop):
    """Per-Gaussian sums [P, F] of the rows [I, F] at ``inv[j]`` over each
    Gaussian's pre-sort run, in run order: the ``segment_sum_rows`` kernel
    on CUDA tensors, :func:`segment_sum_rows_reference` on CPU tensors."""
    if rows.device.type == "cpu":
        return segment_sum_rows_reference(rows, inv, gauss_start, gauss_stop)
    _check_cuda(rows, torch.float32, "rows")
    _check_cuda(inv, torch.int32, "inv")
    _check_cuda(gauss_start, torch.int32, "gauss_start")
    _check_cuda(gauss_stop, torch.int32, "gauss_stop")
    if (rows.dim() != 2 or inv.shape != (rows.shape[0],)
            or gauss_stop.shape != gauss_start.shape
            or gauss_start.dim() != 1):
        raise ValueError("segment_sum_rows takes rows [I, F], inv [I] and "
                         "gauss_start/gauss_stop [P]")
    from ._build import load
    p, f = gauss_start.shape[0], rows.shape[1]
    out = torch.empty((p, f), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load("render_bwd").segment_sum_rows(
            rows.data_ptr(), inv.data_ptr(), gauss_start.data_ptr(),
            gauss_stop.data_ptr(), out.data_ptr(), p, f, stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum_rows launch failed: CUDA error {rc}")
    launches["segment_sum_rows"] += 1
    row_launches[f] = row_launches.get(f, 0) + 1
    return out
