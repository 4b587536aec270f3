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

On a ("dcn", axis) mesh each process scans only its own chunks: its
chunks' totals are gathered across the processes
(parallel/collectives.gather), every process folds the totals of the
chunks before its first, and the input and output cover its rows: its
steps, preceded by the step before them when it has one (`process_rows`),
whose input element is not read and whose output is the exclusive prefix
of its first chunk (the filtered moments the prediction of its first
step needs).
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
from smoothsde_tpu_torch.parallel.collectives import gather


def process_rows(n: int, mesh: Mesh):
    """(lo, start, sizes): this process's chunks of an n-step sequence cut
    into mesh.n_shards chunks are the `sizes` steps from `start` on; lo
    is start - 1, the step before them, or 0 at the sequence's start."""
    all_sizes = shard_sizes(n, mesh.n_shards)
    off = mesh.shard_offset
    start = sum(all_sizes[:off])
    return max(start - 1, 0), start, all_sizes[off:off + len(mesh.devices)]


def _identity_element(s: int, dtype, device) -> _Element:
    return _Element(
        A=torch.eye(s, dtype=dtype, device=device),
        b=torch.zeros((s,), dtype=dtype, device=device),
        C=torch.zeros((s, s), dtype=dtype, device=device),
        eta=torch.zeros((s,), dtype=dtype, device=device),
        J=torch.zeros((s, s), dtype=dtype, device=device),
    )


def _shard(leaves, sizes, mesh: Mesh, dim: int):
    """Each leaf cut along `dim` into chunks of `sizes` (this process's):
    a list over its shards of the leaves' chunks, each on its device."""
    parts = [x.split(sizes, dim=dim) for x in leaves]
    return [[p[r].to(dev) for p in parts]
            for r, dev in enumerate(mesh.devices)]


def _earlier_totals(totals, mesh: Mesh):
    """The totals (a list of leaf lists, one a local chunk) of every chunk
    before this process's first, in order: gathered across the processes
    on a ("dcn", axis) mesh, none on one process."""
    if mesh.processes is None:
        return []
    stacked = [gather(torch.stack(xs), 0, mesh.processes)
               for xs in zip(*totals)]
    return [[x[r] for x in stacked] for r in range(mesh.shard_offset)]


def _sharded_prefix_scan(elems: _Element, mesh: Mesh, axis: str,
                         local_scan: str = "associative",
                         n: int = None) -> _Element:
    """Inclusive scan of full-state filtering elements (leaves (n, s, s),
    (n, s)) with the step axis cut over mesh[axis]. local_scan: how a
    shard scans its chunk, "associative" (the odd/even recursion of
    ops/kalman.py, the card's) or "sequential" (one combine a step). On a
    ("dcn", axis) mesh `elems` and the result cover this process's rows
    of an n-step sequence (module docstring). Returns the scanned
    elements on the input's device."""
    home = elems.A.device
    lo, start, sizes = process_rows(elems.A.shape[0] if n is None else n,
                                    mesh)
    body = [x[start - lo:] for x in elems]
    scanned, totals = [], []
    for chunk in _shard(body, sizes, mesh, 0):
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
        totals.append([x[-1].to(home) for x in e])
    # exclusive prefix of the chunks' totals, each back on its device
    pref = _identity_element(elems.A.shape[-1], elems.A.dtype, home)
    for tot in _earlier_totals(totals, mesh):
        pref = _combine(pref, _Element(*tot))
    out = [_Element(*(x[None] for x in pref))] if lo < start else []
    for e, tot in zip(scanned, totals):
        dev = e.A.device
        p = _Element(*(x.to(dev)[None] for x in pref))
        out.append(_combine(p, e))
        pref = _combine(pref, _Element(*tot))
    return _Element(*(torch.cat([x.to(home) for x in xs])
                      for xs in zip(*out)))


def kalman_filter_time_sharded(steps: KalmanSteps, mesh: Mesh,
                               axis: str = "time",
                               local_scan: str = "associative",
                               n: int = None):
    """The parallel Kalman filter with the step axis cut over mesh[axis]:
    the elements and the likelihood terms are built on the steps' device,
    the scan is sharded. Returns (llk, filtered means (n, s)). On a
    ("dcn", axis) mesh `steps` cover this process's rows of an n-step
    sequence (`process_rows`: the leaves of the whole sequence's steps
    cut to [lo, start + sum(sizes))) and the result is its part: the llk
    of its steps and their filtered means."""
    scanned = _sharded_prefix_scan(_build_elements(steps), mesh, axis,
                                   local_scan, n)
    m_f, P_f = scanned.b, scanned.C
    terms = predictive_loglik_terms(steps, m_f, P_f)
    skip = 0
    if n is not None:
        lo, start, _ = process_rows(n, mesh)
        skip = start - lo
    return terms[skip:].sum(), m_f[skip:]


def soa_sharded_prefix_scan(combine, identity, elems, mesh: Mesh, axis: str,
                            local_scan: str = "blocked", n: int = None):
    """Inclusive scan along the LAST axis of structure-of-arrays elements
    (leaves broadcasting to (..., n), as ops/kalman_soa._scan_elements
    takes) with that axis cut over mesh[axis]: each shard scans its chunk
    with `_scan_elements(combine, identity, chunk, local_scan)` ("blocked",
    "associative", "sequential"; any of its scans). On a ("dcn", axis)
    mesh `elems` and the result cover this process's rows of an n-step
    sequence (module docstring). Returns the scanned pytree on the
    input's device."""
    from smoothsde_tpu_torch.ops.kalman_soa import _scan_elements
    from smoothsde_tpu_torch.ops.scan_utils import elem_kind

    kind = elem_kind(combine)
    leaves = kind.pack(elems)
    shape = torch.broadcast_shapes(*(x.shape for x in leaves))
    home = leaves[0].device
    lo, start, sizes = process_rows(shape[-1] if n is None else n, mesh)
    body = [x.expand(shape)[..., start - lo:] for x in leaves]
    scanned, totals = [], []
    for chunk in _shard(body, sizes, mesh, -1):
        sc = kind.pack(_scan_elements(combine, identity, kind.unpack(chunk),
                                      local_scan))
        scanned.append(sc)
        totals.append([x[..., -1].to(home) for x in sc])
    pref = [torch.full(shape[:-1], v, dtype=leaves[0].dtype, device=home)
            for v in kind.pack(identity)]
    for tot in _earlier_totals(totals, mesh):
        pref = kind.pack(combine(kind.unpack(pref), kind.unpack(tot)))
    out = [[x[..., None] for x in pref]] if lo < start else []
    for sc, tot in zip(scanned, totals):
        p1 = kind.unpack([x.to(sc[0].device)[..., None] for x in pref])
        out.append(kind.pack(combine(p1, kind.unpack(sc))))
        pref = kind.pack(combine(kind.unpack(pref), kind.unpack(tot)))
    return kind.unpack([torch.cat([x.to(home) for x in xs], dim=-1)
                        for xs in zip(*out)])
