"""Blocked (two-phase) associative scan and its phase-1 kernel K8.

Port of smoothsde_tpu/ops/scan_utils.py. The scan axis of an element
pytree is cut into the lanes of ops/ctcrw_fused.py's `plan` (lane
`dd * NB + b` owns steps b*L .. b*L + L - 1 of row dd, L ~ 32) and laid
out as one time-major stack (L, C, lanes), C the element's components:

  phase 1: the inclusive scan within each lane, written at every step
           (`pallas_phase1_scan`: the CUDA kernel K8 for CUDA tensors,
           its plain version for CPU tensors);
  phase 2: the exclusive cross-lane prefix of the lane totals, segmented
           per row (with phase1="pallas" K2, ops/ctcrw_fused.py
           `block_prefix`; with phase1="plain" its plain version, so that
           the "plain" scan reaches no kernel and torch.func transforms
           it, as the JAX package's XLA phases);
  phase 3: one elementwise combine(prefix, within), torch ops (XLA
           computes it in the JAX package).

`reverse=True` scans from the last step to the first (the RTS
smoother's order): K8 walks each lane backwards and K2 takes the
suffix, which replaces the JAX package's flip / scan / flip. The
combine must be one the element table ops/ctcrw_fused.py `ELEMS` knows,
and K8 and K2 are built for each: the CTCRW filtering and smoothing
elements (`_combine2`, `_combine2_rev`), the scalar-state ones (`_comb1`,
`_comb1_rev`) and the square-root ones (`_combine_sqrt2`,
`_combine_sqrt1`, ops/kalman_sqrt.py). The kernels are forward-only, as
the JAX package's phase-1 kernel: a gradient through a launch raises.

The JAX package's TPU geometry (NB = 2048 blocks, L_CH = 32, the
fallback to an XLA phase 1 when lanes % 1024 != 0) is not carried over:
K8 runs at every (d, n).
"""

from __future__ import annotations

import math

import torch

from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.ops.kalman_smooth import _comb1_rev, _combine2_rev
from smoothsde_tpu_torch.ops.kalman_soa import _comb1, _combine2
from smoothsde_tpu_torch.ops.kalman_sqrt import _combine_sqrt1, _combine_sqrt2

_KINDS = {
    _combine2: "filter",
    _combine2_rev: "smooth",
    _comb1: "diag_filter",
    _comb1_rev: "diag_smooth",
    _combine_sqrt2: "sqrt2",
    _combine_sqrt1: "sqrt1",
}


def _kind_name(combine) -> str:
    if combine not in _KINDS:
        raise ValueError(f"no element kind for combine {combine!r}")
    return _KINDS[combine]


def elem_kind(combine) -> cf._ElemKind:
    """The ELEMS entry (combine, pack, unpack, identity) of a combine."""
    return cf.ELEMS[_kind_name(combine)]


def pallas_phase1_scan_plain(stack, elem: str, reverse=False):
    """K8's plain version: inclusive scan of each lane's L steps, (L, C,
    lanes) -> (L, C, lanes), in step order (last step first if
    reverse)."""
    k = cf.ELEMS[elem]
    L = stack.shape[0]
    c = k.unpack(cf._identity(k.id_vals, stack[0, 0]))
    out = [None] * L
    for l in (reversed(range(L)) if reverse else range(L)):
        c = k.combine(c, k.unpack(stack[l].unbind(0)))
        out[l] = torch.stack(k.pack(c))
    return torch.stack(out)


def pallas_phase1_scan(stack, elem: str, reverse=False):
    """K8 wrapper; see pallas_phase1_scan_plain. elem: any ELEMS kind
    ("filter" 14-comp, "smooth" 9, "diag_filter" 5, "diag_smooth" 3,
    "sqrt2" 14, "sqrt1" 5)."""
    if not cf._on_cuda(stack):
        return pallas_phase1_scan_plain(stack, elem, reverse)
    L, C, lanes = stack.shape
    if C != len(cf.ELEMS[elem].id_vals):
        raise ValueError(f"stack shape {tuple(stack.shape)} for {elem}")
    out = torch.empty_like(stack)
    cf._launch(f"phase1_scan_{elem}", stack, out, L, lanes,
               int(bool(reverse)))
    return out


def blocked_associative_scan(combine, identity, elems, phase1="plain",
                             reverse=False):
    """Inclusive associative scan along the LAST axis of every leaf.

    combine: an ELEMS combine, combine(earlier, later) in scan order;
    identity: its identity element (a pytree of floats); elems: element
    pytree whose leaves broadcast to one shape (..., n). phase1: "plain"
    (the plain within-lane scan) or "pallas" (`pallas_phase1_scan`: K8
    for CUDA tensors, with K2 for phase 2; "plain" runs no kernel).
    Returns the scanned pytree, leaves (..., n)."""
    kind_name = _kind_name(combine)
    kind = cf.ELEMS[kind_name]
    leaves = kind.pack(elems)
    shape = torch.broadcast_shapes(*(x.shape for x in leaves))
    n, lead = shape[-1], shape[:-1]
    rows = math.prod(lead)
    x = torch.stack([v.expand(shape).reshape(rows, n) for v in leaves])
    p = cf.plan(rows, n)
    stack = cf.pad_to_lanes(x, kind.pack(identity), p)  # identity padding
    if phase1 == "pallas":
        within = pallas_phase1_scan(stack, kind_name, reverse)
    elif phase1 == "plain":
        within = pallas_phase1_scan_plain(stack, kind_name, reverse)
    else:
        raise ValueError(f"unknown phase1 {phase1!r}")
    totals = within[0 if reverse else -1].contiguous()
    prefix = cf.block_prefix if phase1 == "pallas" else cf.block_prefix_plain
    excl = prefix(totals, rows, kind_name, reverse)
    out = kind.pack(combine(kind.unpack(excl.unbind(0)),
                            kind.unpack(within.unbind(1))))
    y = cf.unstack(torch.stack(out, dim=1), p)  # (C, rows, n)
    return kind.unpack(list(y.reshape((len(out),) + shape).unbind(0)))
