"""Along-time (sequence-parallel) filtering over a device mesh.

Port of smoothsde_tpu/parallel/time_scan.py. For a track too long for
one device, the associative filter is distributed by the block-scan
decomposition: each shard scans its own chunk of elements, the chunks'
totals are gathered on the first shard's device, each chunk's exclusive
prefix (the composition of the totals before it) is copied back, and
composed into the chunk's scanned elements. The gather of O(shards s^2)
values and the copies back are the only communication. Plain tensor
arithmetic: every order of torch.func runs through it, so it is the
generic route's filter (user H / P0, ESEAL_SSM) and the forward-mode
twin of the time-sharded kernels (parallel/dist.py).
"""

from __future__ import annotations

import torch

from smoothsde_tpu_torch.ops.kalman import (
    KalmanSteps,
    _associative_scan,
    _build_elements,
    _combine,
    _Element,
    predictive_loglik_terms,
)
from smoothsde_tpu_torch.parallel.batching import Mesh, shard_sizes


def _identity_element(s: int, dtype, device) -> _Element:
    return _Element(
        A=torch.eye(s, dtype=dtype, device=device),
        b=torch.zeros((s,), dtype=dtype, device=device),
        C=torch.zeros((s, s), dtype=dtype, device=device),
        eta=torch.zeros((s,), dtype=dtype, device=device),
        J=torch.zeros((s, s), dtype=dtype, device=device),
    )


def _shard(leaves, mesh: Mesh, axis: str, dim: int):
    """Each leaf cut along `dim` into mesh.shape[axis] contiguous chunks:
    a list over shards of the leaves' chunks, each on its device."""
    sizes = shard_sizes(leaves[0].shape[dim], mesh.shape[axis])
    parts = [x.split(sizes, dim=dim) for x in leaves]
    return [[p[r].to(dev) for p in parts]
            for r, dev in enumerate(mesh.devices)]


def _sharded_prefix_scan(elems: _Element, mesh: Mesh, axis: str,
                         local_scan: str = "associative") -> _Element:
    """Inclusive scan of full-state filtering elements (leaves (n, s, s),
    (n, s)) with the step axis cut over mesh[axis]. local_scan: how a
    shard scans its chunk, "associative" (the odd/even recursion of
    ops/kalman.py, the card's) or "sequential" (one combine a step).
    Returns the scanned elements on the input's device."""
    home = elems.A.device
    scanned, totals = [], []
    for chunk in _shard(list(elems), mesh, axis, 0):
        e = _Element(*chunk)
        if local_scan == "sequential":
            carry = _identity_element(e.A.shape[-1], e.A.dtype, e.A.device)
            outs = []
            for i in range(e.A.shape[0]):
                carry = _combine(carry, _Element(*(x[i] for x in e)))
                outs.append(carry)
            e = _Element(*(torch.stack(xs) for xs in zip(*outs)))
        elif local_scan == "associative":
            e = _associative_scan(_combine, e, 0)
        else:
            raise ValueError(f"unknown local scan {local_scan!r}")
        scanned.append(e)
        totals.append(_Element(*(x[-1].to(home) for x in e)))
    # exclusive prefix of the chunks' totals, each back on its device
    pref = _identity_element(elems.A.shape[-1], elems.A.dtype, home)
    out = []
    for e, tot in zip(scanned, totals):
        dev = e.A.device
        p = _Element(*(x.to(dev)[None] for x in pref))
        out.append(_combine(p, e))
        pref = _combine(pref, tot)
    return _Element(*(torch.cat([x.to(home) for x in xs])
                      for xs in zip(*out)))


def kalman_filter_time_sharded(steps: KalmanSteps, mesh: Mesh,
                               axis: str = "time",
                               local_scan: str = "associative"):
    """The parallel Kalman filter with the step axis cut over mesh[axis]:
    the elements and the likelihood terms are built on the steps' device,
    the scan is sharded. Returns (llk, filtered means (n, s))."""
    scanned = _sharded_prefix_scan(_build_elements(steps), mesh, axis,
                                   local_scan)
    m_f, P_f = scanned.b, scanned.C
    return predictive_loglik_terms(steps, m_f, P_f).sum(), m_f


def soa_sharded_prefix_scan(combine, identity, elems, mesh: Mesh, axis: str,
                            local_scan: str = "blocked"):
    """Inclusive scan along the LAST axis of structure-of-arrays elements
    (leaves broadcasting to (..., n), as ops/kalman_soa._scan_elements
    takes) with that axis cut over mesh[axis]: each shard scans its chunk
    with `_scan_elements(combine, identity, chunk, local_scan)` ("blocked",
    "associative", "sequential"; any of its scans). Returns the scanned
    pytree on the input's device."""
    from smoothsde_tpu_torch.ops.kalman_soa import _scan_elements
    from smoothsde_tpu_torch.ops.scan_utils import elem_kind

    kind = elem_kind(combine)
    leaves = kind.pack(elems)
    shape = torch.broadcast_shapes(*(x.shape for x in leaves))
    home = leaves[0].device
    scanned, totals = [], []
    for chunk in _shard([x.expand(shape) for x in leaves], mesh, axis, -1):
        sc = kind.pack(_scan_elements(combine, identity, kind.unpack(chunk),
                                      local_scan))
        scanned.append(sc)
        totals.append([x[..., -1].to(home) for x in sc])
    pref = [torch.full(shape[:-1], v, dtype=leaves[0].dtype, device=home)
            for v in kind.pack(identity)]
    out = []
    for sc, tot in zip(scanned, totals):
        p1 = kind.unpack([x.to(sc[0].device)[..., None] for x in pref])
        out.append(kind.pack(combine(p1, kind.unpack(sc))))
        pref = kind.pack(combine(kind.unpack(pref), kind.unpack(tot)))
    return kind.unpack([torch.cat([x.to(home) for x in xs], dim=-1)
                        for xs in zip(*out)])
