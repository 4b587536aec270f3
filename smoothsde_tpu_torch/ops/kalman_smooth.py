"""RTS smoothing-element algebra for the SoA Kalman smoothers.

Port of the element algebra of smoothsde_tpu/ops/kalman_smooth.py
(Smooth2, _combine2_rev, _ID_S2) and of its scalar-state counterpart in
smoothsde_tpu/ops/diag_fused.py (`_comb1_rev`, `_ID1_SM`). The smoothers
run inside the fused backwards (ops/ctcrw_fused.py, ops/diag_fused.py and
their csrc/ kernels), where these elements are composed in reverse time
to give the Fisher-identity score.
"""

from __future__ import annotations

from typing import NamedTuple

from smoothsde_tpu_torch.ops.kalman_soa import _m2, _madd, _mv, _symm, _t2, _vadd


class Smooth2(NamedTuple):
    """RTS smoothing element (E, g, L): x_i | x_{i+1} map."""

    E: tuple
    g: tuple
    L: tuple


def _combine2_rev(acc: Smooth2, new: Smooth2) -> Smooth2:
    """Compose a new element OUTSIDE the accumulator: scanning the
    flipped (end-first) sequence, acc covers indices > i and new is the
    element at i; result = new applied to acc."""
    E = _m2(new.E, acc.E)
    g = _vadd(_mv(new.E, acc.g), new.g)
    L = _symm(_madd(_m2(_m2(new.E, acc.L), _t2(new.E)), new.L))
    return Smooth2(E, g, L)


_ID_S2 = Smooth2(
    E=((1.0, 0.0), (0.0, 1.0)),
    g=(0.0, 0.0),
    L=((0.0, 0.0), (0.0, 0.0)),
)


def _comb1_rev(acc, new):
    """Scalar-state (E, g, L) smoothing composition, `new` applied
    outside the accumulator (smoothsde_tpu/ops/diag_fused.py `_comb1_rev`)."""
    Ea, ga, La = acc
    En, gn, Ln = new
    return (En * Ea, En * ga + gn, En * En * La + Ln)


_ID1_SM = (1.0, 0.0, 0.0)
