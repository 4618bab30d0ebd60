"""The work of the Full variant's dual blend and preprocess, beside
``work.py``'s light counts, in the same units.

Over the light dual blend (``work.blend_jvp``), per tangent:

- the Σ2D branch: three fused multiply-adds a contributing pair (the
  conic's three terms of the exponent's derivative) and three floats an
  instance (dA, dB, dC);
- the SH colour branch: three fused multiply-adds a contributing pair
  (``dcolor += tcolor w``) and three floats an instance (dr, dg, db).

So six twist tangents add 18 fused multiply-adds a pair and 72 bytes an
instance for each branch.  A fused multiply-add counts two operations, as
the float32 peak counts it.  The preprocess of a Gaussian with SH of
degree d reads ``3 (d + 1)^2`` coefficients where degree 0 reads three.
"""

from __future__ import annotations

from . import work as W

FMA = 2                  # operations of one fused multiply-add
BRANCH_FMAS = 3          # a tangent a contributing pair, for each branch
BRANCH_FLOATS = 3        # a tangent an instance, for each branch


def blend_jvp_full(inst, contrib, px, tiles, k: int = 6, cov: bool = True,
                   color: bool = True) -> W.Piece:
    """The dual blend with ``k`` tangents of the full pose chain: the
    light count plus each branch that is on."""
    n = int(cov) + int(color)
    return W.blend_jvp(inst, contrib, px, tiles, k) + W.Piece(
        contrib * k * n * BRANCH_FMAS * FMA,
        W.F4 * inst * k * n * BRANCH_FLOATS)


def preprocess_sh(gauss, degree: int) -> W.Piece:
    """The projection of Gaussians with SH of ``degree``: ``work.
    preprocess`` plus the coefficients beyond the DC term read, and their
    evaluation (about five operations a coefficient and channel)."""
    extra = 3 * ((degree + 1) ** 2 - 1)
    return W.preprocess(gauss) + W.Piece(gauss * 5 * extra,
                                         W.F4 * gauss * extra)
