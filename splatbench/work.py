"""The work of a step, counted from shapes and from what the reference
derives from the benchmark's own inputs, and the card's peaks.

A roofline bound is the larger of the operations over the float32 peak
and the bytes over the memory bandwidth; every input and output byte of a
piece of work counts once.  Pair tests count only for the pairs that
contribute (the least a blend that stops at its last contributor needs),
so every bound here is a floor on the time, never above it.

Operation counts of one pair of a blend (float32):

- ``TEST``: the splat exponent, its exponential, the alpha cap and the two
  threshold tests (23 operations);
- ``ACC``: the forward accumulation of one contribution (weight,
  transmittance, three colour channels, depth, silhouette; 16);
- ``BWD``: the backward of one contribution (the alpha, conic, centre,
  colour and depth gradients of that pair; 60);
- ``JVP``: one pose tangent of one contribution (the alpha's derivative
  through the centre and the depth, then the carried sums; 24).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import reference as ref

FP32_FLOPS = 67e12       # NVIDIA H100 SXM, float32 outside the tensor cores
HBM_BYTES = 3.35e12      # bytes/s, HBM3
TEST, ACC, BWD, JVP = 23, 16, 60, 24
PIX = 5                  # per pixel: finish and write
PREP_F, PREP_B = 200, 400  # projection ops a Gaussian, forward / backward
F4 = 4


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES)


class Piece(NamedTuple):
    ops: float
    nbytes: float

    def __add__(self, o):
        return Piece(self.ops + o.ops, self.nbytes + o.nbytes)

    def scaled(self, s: float) -> "Piece":
        return Piece(self.ops * s, self.nbytes * s)


ZERO = Piece(0.0, 0.0)


def blend_fwd(inst, contrib, px, tiles) -> Piece:
    """The forward blend and its per-instance sums: the sorted feature
    table in (11 floats an instance), the ground-truth depth in, six float
    and three integer planes out, two sums an instance out."""
    return Piece(contrib * (TEST + ACC) + px * PIX,
                 F4 * (inst * 11 + tiles * 2 + px + px * 9 + inst * 2))


def blend_bwd(inst, contrib, px, tiles, gauss) -> Piece:
    """The backward blend with its per-Gaussian sums: the table, five
    totals, six cotangents and the stop index in; the permutation and the
    runs in; twelve gradient columns a Gaussian out."""
    return Piece(contrib * (TEST + BWD) + px * PIX,
                 F4 * (inst * 11 + tiles * 2 + px * 12 + inst + gauss * 2
                       + gauss * 12))


def blend_jvp(inst, contrib, px, tiles, k: int = 6) -> Piece:
    """The dual blend with ``k`` light pose tangents (centre and depth:
    three floats a tangent an instance) and its per-instance sums."""
    return Piece(contrib * (TEST + ACC + k * JVP) + px * PIX,
                 F4 * (inst * (11 + 3 * k) + tiles * 2 + px
                       + px * (9 + 5 * k) + inst * 2))


def preprocess(gauss, backward: bool = False) -> Piece:
    """The projection: 14 floats a Gaussian in, 11 out (the backward reads
    both and writes 14)."""
    if backward:
        return Piece(gauss * PREP_B, F4 * gauss * (14 + 11 + 14))
    return Piece(gauss * PREP_F, F4 * gauss * (14 + 11))


def binning(inst) -> Piece:
    """The (tile, depth) sort of the instances: keys and indices read and
    written once (16 bytes an instance)."""
    return Piece(0.0, 16.0 * inst)


def adam(n_params) -> Piece:
    """Adam: parameter, gradient and two moments in; parameter and moments
    out."""
    return Piece(12.0 * n_params, F4 * 7 * n_params)


class Work(NamedTuple):
    """Named pieces of one unit of work (a step or a frame)."""

    pieces: dict

    def get(self, name: str) -> Piece:
        return self.pieces.get(name, ZERO)

    def total(self) -> Piece:
        out = ZERO
        for p in self.pieces.values():
            out = out + p
        return out

    @classmethod
    def none(cls) -> "Work":
        return cls({})


def tiles(cam, R) -> int:
    """The number of tiles of the image."""
    tx, ty = ref.grid(cam, R)
    return tx * ty


def pool_counts(fields: dict, views, cam, R):
    """(instances, contributing pairs) of the reference's render of
    ``fields`` at each of ``views``: instances are the (Gaussian, tile)
    pairs whose alpha-floor ellipse reaches the tile."""
    f = ref.gaussian_fields(*(fields[k] for k in ref.FIELDS),
                            fields["active"])
    out = []
    with torch.no_grad():
        for v in views:
            sp = ref.project(f, v, cam, R)
            bins = ref.bin_pairs(sp, cam, R, margin=1.0, exact_margin=0.0)
            _, _, _, contrib, inst = ref.render(f, v, cam, R, bins=bins,
                                                count=True)
            out.append((inst, contrib))
    return out
