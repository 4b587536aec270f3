"""Sharded likelihoods over a device mesh, wired into the objective layer
so that `SDE.fit(mesh=..., mesh_axis=...)` runs sharded.

Port of smoothsde_tpu/parallel/dist.py on the single-controller mesh of
parallel/batching.py. Two axes:

  - "tracks" (`build_sharded_loglik`): tracks are independent, so the
    likelihood is a sum of per-track terms. `pack_layout` assigns whole
    tracks to the shards, K_pad / shards consecutive tracks each (the JAX
    package's assignment); each shard evaluates infer/objective.py's
    `rows_likelihood` on its tracks' rows, on its device: the fused
    kernels for the isotropic state-space models (the JAX package's
    `_build_sharded_soa_loglik`), the generic full-state filter, the
    closed-form densities, with their forward-mode twins. A shard's rows
    are one contiguous range of the flat data, cut from the replicated
    linear predictor by `split` (its backward one concatenation): no row
    gather, whose CUDA backward (an atomic index_add) sums in an order
    that varies between runs, and no padding, which the JAX package
    needs only because shard_map wants equal shapes.
  - "time" (`build_time_sharded_loglik`): one long sequence cut into
    consecutive chunks of as equal sizes as can be (no dummy padding
    track, for the same reason), each on its device, stitched exactly
    across the chunks' edges: the kernel cores of
    ops/kalman_soa.TimeShardedCtcrwCore and
    ops/diag_fused.TimeShardedDiagCore for CTCRW, BM_SSM and OU_SSM (the
    JAX `_build_time_sharded_fused_ctcrw` / `_diag`; on a CPU mesh the
    same cores on the plain op tables), with the sharded SoA scan of
    parallel/time_scan.py as their forward-mode twin (the JAX
    `_build_time_sharded_soa_loglik`), and the time-sharded full-state
    filter on the generic route (user H / P0, ESEAL_SSM).

Every builder returns `Sharded(loglik, loglik_ad)`: the value route and
its twin, each fn(full, par_full) -> 0-d tensor on par_full's device,
par_full the (n, n_par) linear predictor on the model's device. The data
term only: ESEAL_SSM's priors are added once by the objective.

On a ("dcn", axis) mesh (parallel/batching.py) the shards are numbered
over every process and each process builds and evaluates only its own
(`Mesh.shard_offset`): its tracks, or its time chunks, whose chunk
totals the stitch gathers across the processes (the kernel cores, and
parallel/time_scan.py for the twin and the generic filter). Each
builder's functions then return this process's part of the sum;
infer/objective.py adds the parts up (parallel/collectives.py
`replicate` / `process_sum`), the one place where the likelihood and its
gradient cross processes. Every process holds the whole data and the
replicated par_full; a chunk's entering par row is read from it, so no
exchange is needed for it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from smoothsde_tpu_torch.parallel.batching import Mesh
from smoothsde_tpu_torch.parallel.time_scan import process_rows


class PackedLayout(NamedTuple):
    """Host-side description of the padded track batch."""

    row_idx: np.ndarray  # (K_pad, L) flat-row index per slot (clamped)
    valid_row: np.ndarray  # (K_pad, L) slot holds a real observation
    times_p: np.ndarray  # (K_pad, L) strictly increasing per track
    n_tracks: int  # real tracks (before device padding)
    lengths: np.ndarray  # (K_pad,) real rows per track (0 for dummies)


def pack_layout(
    times: np.ndarray,
    ids: np.ndarray,
    n_devices: int,
    pad_multiple: int = 8,
) -> PackedLayout:
    """Compute the padded (K_pad, L) batch layout for a flat dataset.

    - tracks are maximal runs of equal `ids` (reference track semantics,
      nllk_sde.hpp:79);
    - L is the longest track rounded up to `pad_multiple`; padding slots
      clamp to the track's last row and extend time by +1 per slot so
      dt stays positive;
    - K is rounded up to a multiple of `n_devices` with dummy tracks
      (valid_row all False) that contribute exactly zero likelihood.
    """
    times = np.asarray(times, float)
    ids = np.asarray(ids)
    n = len(ids)
    starts = np.concatenate(
        [[0], np.where(ids[1:] != ids[:-1])[0] + 1, [n]]
    )
    K = len(starts) - 1
    lens = np.diff(starts)
    L = int(-(-int(lens.max()) // pad_multiple) * pad_multiple)
    K_pad = int(-(-K // n_devices) * n_devices)

    row_idx = np.zeros((K_pad, L), np.int32)
    valid = np.zeros((K_pad, L), bool)
    t_p = np.tile(np.arange(L, dtype=float), (K_pad, 1))
    lengths = np.zeros(K_pad, np.int64)
    for k in range(K):
        s, e = starts[k], starts[k + 1]
        m = e - s
        row_idx[k, :m] = np.arange(s, e)
        row_idx[k, m:] = e - 1
        valid[k, :m] = True
        t_p[k, :m] = times[s:e]
        t_p[k, m:] = times[e - 1] + 1.0 + np.arange(L - m)
        lengths[k] = m
    return PackedLayout(row_idx, valid, t_p, K, lengths)


class Sharded(NamedTuple):
    """A sharded log-likelihood's value route and forward-mode twin."""

    loglik: Callable
    loglik_ad: Callable


# the named parameters a likelihood reads besides the linear predictor
_LIK_PARAMS = ("log_sigma_obs", "log_tau", "a1", "log_a2")
# ESEAL_SSM's per-row data
_ROW_DATA = ("h", "R", "dep_fat")


def _ops_name(mesh: Mesh) -> str:
    """The kernel cores' op table: the CUDA kernels on a card, their
    plain versions on the CPU."""
    return "kernels" if mesh.devices[0].type == "cuda" else "plain"


def build_sharded_loglik(
    spec,
    obs: np.ndarray,
    times: np.ndarray,
    ids: np.ndarray,
    mesh: Mesh,
    axis: str = "tracks",
    other_data: Optional[dict] = None,
    kalman_impl: str = "auto",
    H_array=None,
    P0=None,
    *,
    dtype=torch.float32,
) -> Sharded:
    """The likelihood with tracks sharded over `mesh`'s `axis`: each
    shard's whole tracks through `rows_likelihood` on its device (empty
    shards, when there are fewer tracks, hold nothing); the shards'
    values are summed on par_full's device (this process's shards on a
    ("dcn", axis) mesh). H_array: (n, m, m)."""
    from smoothsde_tpu_torch.infer.objective import rows_likelihood

    _check_axis(mesh, axis)
    other_data = dict(other_data or {})
    n_dev = mesh.n_shards
    layout = pack_layout(times, ids, n_dev)
    per = len(layout.lengths) // n_dev
    starts = np.concatenate([[0], np.cumsum(layout.lengths)])
    shards, sizes, first = [], [], None
    for j, dev in enumerate(mesh.devices):
        r = mesh.shard_offset + j
        k0, k1 = r * per, min((r + 1) * per, layout.n_tracks)
        if k0 >= k1:
            continue
        s, e = int(starts[k0]), int(starts[k1])
        first = s if first is None else first
        rows = {k: np.asarray(v)[s:e] for k, v in other_data.items()
                if k in _ROW_DATA}
        rows.update({k: v for k, v in other_data.items()
                     if k not in _ROW_DATA})
        lik = rows_likelihood(
            spec, np.asarray(obs)[s:e], np.asarray(times)[s:e],
            np.asarray(ids)[s:e], rows,
            None if H_array is None else np.asarray(H_array)[s:e], P0,
            kalman_impl, dtype=dtype, device=dev)
        shards.append((lik, dev))
        sizes.append(e - s)
    n = len(ids)
    first = first or 0
    # this process's rows, one contiguous range, cut by one split (its
    # backward one concatenation)
    cut = [first, *sizes, n - first - sum(sizes)]

    def summed(which):
        def loglik(full, par_full):
            parts = par_full.split(cut)[1:-1]
            if not shards:  # a process without tracks: a zero on the graph
                return par_full[:0].sum()
            vals = []
            for (lik, dev), part in zip(shards, parts):
                f = {k: full[k].to(dev) for k in _LIK_PARAMS if k in full}
                vals.append(getattr(lik, which)(f, part.to(dev)).to(
                    par_full.device))
            return torch.stack(vals).sum()

        return loglik

    return Sharded(summed("value"), summed("ad"))


def _check_axis(mesh: Mesh, axis: str):
    if axis != mesh.axis:
        raise ValueError(f"mesh {mesh} shards no axis {axis!r}")


def build_time_sharded_loglik(
    spec,
    obs: np.ndarray,
    times: np.ndarray,
    ids: np.ndarray,
    mesh: Mesh,
    axis: str = "time",
    other_data: Optional[dict] = None,
    H_array=None,
    P0=None,
    kalman_impl: str = "auto",
    *,
    dtype=torch.float32,
    device="cpu",
) -> Sharded:
    """The likelihood with the TIME axis of the (one- or multi-track)
    step sequence cut over `mesh`'s `axis`, stitched across the chunks'
    edges: the layout for one enormous track, where track sharding has
    nothing to split. `device`: the model's (where par_full lives and
    the twin and the generic filter build their elements). Closed-form
    models raise, as in the JAX package (their per-step terms need no
    scan to shard)."""
    from smoothsde_tpu_torch.models.ssm import SSM_STEP_BUILDERS
    from smoothsde_tpu_torch.ops.kalman import default_filter_impl
    from smoothsde_tpu_torch.ops.kalman_soa import precompute_dt
    from smoothsde_tpu_torch.parallel.time_scan import (
        kalman_filter_time_sharded,
    )

    if spec.kind != "ssm":
        raise NotImplementedError(
            "time-sharded likelihood covers the Kalman family "
            "(closed-form models are GSPMD-shardable as-is)"
        )
    _check_axis(mesh, axis)
    other_data = dict(other_data or {})
    device = torch.device(device)
    if len(ids) < mesh.n_shards:
        raise ValueError(f"{len(ids)} steps cannot fill {mesh.n_shards} "
                         "shards")
    if (spec.type in ("CTCRW", "BM_SSM", "OU_SSM") and H_array is None
            and P0 is None):
        build = (_build_time_sharded_fused_ctcrw if spec.type == "CTCRW"
                 else _build_time_sharded_fused_diag)
        return Sharded(
            build(spec, obs, times, ids, mesh, axis, dtype=dtype),
            _build_time_sharded_soa_loglik(spec, obs, times, ids, mesh, axis,
                                           dtype=dtype, device=device))
    impl = default_filter_impl(device) if kalman_impl == "auto" \
        else kalman_impl
    if impl not in ("sequential", "parallel"):
        raise ValueError(f"kalman_impl {kalman_impl!r} on the generic route")
    local_scan = "associative" if impl == "parallel" else "sequential"

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=device, dtype=dtype)

    obs_t = dev(obs)
    ids_t = torch.as_tensor(np.asarray(ids), device=device)
    dt_t = dev(precompute_dt(times, ids))
    P0_t = None if P0 is None else dev(P0)
    H_t = None if H_array is None else dev(H_array)
    builder = SSM_STEP_BUILDERS[spec.type]
    if spec.type == "ESEAL_SSM":
        eseal_data = [dev(other_data[k]) for k in _ROW_DATA]
    n = len(ids)
    lo, start, sizes = process_rows(n, mesh)
    hi = start + sum(sizes)

    def loglik(full, par_full):
        if spec.type == "ESEAL_SSM":
            steps = builder(par_full, obs_t, None, ids_t, full["log_tau"][0],
                            full["a1"][0], full["log_a2"][0], *eseal_data,
                            P0=P0_t, dt=dt_t)
        else:
            steps = builder(par_full, obs_t, None, ids_t,
                            sigma_obs=torch.exp(full["log_sigma_obs"][0]),
                            H_array=H_t, P0=P0_t, dt=dt_t)
        # this process's rows of the whole sequence's steps
        steps = type(steps)(*(x[lo:hi] for x in steps))
        return kalman_filter_time_sharded(steps, mesh, axis, local_scan,
                                          n)[0]

    return Sharded(loglik, loglik)


def _build_time_sharded_fused_ctcrw(spec, obs, times, ids, mesh: Mesh,
                                    axis: str, *, dtype, ops_name=None):
    """Time-sharded CTCRW on the kernel core TimeShardedCtcrwCore: the
    per-step data and the masks that look across the chunks' edges are
    formed on the whole sequence on the host, then cut. ops_name: the op
    table (the mesh's, `_ops_name`, if None)."""
    from smoothsde_tpu_torch.ops.kalman_soa import (
        fused_par_core_time_sharded,
        prepare_ctcrw_data,
        split_ctcrw_data,
    )

    lo, start, sizes = process_rows(len(ids), mesh)
    chunks = split_ctcrw_data(
        prepare_ctcrw_data(obs, times, ids, dtype=dtype, device="cpu"),
        sizes, mesh.devices, start)
    ops_name = ops_name or _ops_name(mesh)
    cut = [start, *sizes, len(ids) - start - sum(sizes)]

    def loglik(full, par_full):
        h = torch.exp(full["log_sigma_obs"][0]) ** 2
        pars = [x.to(dev) for x, dev in zip(par_full.split(cut)[1:-1],
                                             mesh.devices)]
        # the par row entering this process's first chunk (its own first
        # at the sequence's start, where it is masked)
        ent = par_full[lo].detach()
        return fused_par_core_time_sharded(pars, chunks, h, ops_name,
                                           procs=mesh.processes, ent=ent)

    return loglik


def _build_time_sharded_fused_diag(spec, obs, times, ids, mesh: Mesh,
                                   axis: str, *, dtype, ops_name=None):
    """Time-sharded BM_SSM / OU_SSM on the kernel core
    TimeShardedDiagCore. Each chunk's transitions come from its own par
    rows and the row before it (`diag_chunk_rows`): the entering side of
    its first slot from the previous chunk's last row, the leaving side
    of its last slot from its own, so every transition across an edge
    survives the cut. The BM_SSM centring path is the whole sequence's.
    ops_name: as in `_build_time_sharded_fused_ctcrw`."""
    from smoothsde_tpu_torch.ops.diag_fused import (
        diag_chunk_rows,
        diag_fused_core_time_sharded,
        prepare_diag_data,
        split_diag_data,
    )

    lo, start, sizes = process_rows(len(ids), mesh)
    chunks = split_diag_data(
        prepare_diag_data(spec.type, obs, times, ids, dtype=dtype,
                          device="cpu"), sizes, mesh.devices, start)
    ops_name = ops_name or _ops_name(mesh)
    cut = [start, *sizes, len(ids) - start - sum(sizes)]

    def loglik(full, par_full):
        h = torch.exp(full["log_sigma_obs"][0]) ** 2
        parts = par_full.split(cut)[1:-1]
        rows = []
        for r, (c, part, dev) in enumerate(zip(chunks, parts, mesh.devices)):
            prev = (parts[r - 1][-1] if r else par_full[lo]).detach().to(dev)
            rows += diag_chunk_rows(spec.type, c, part.to(dev), prev)
        return diag_fused_core_time_sharded(rows, chunks, h, ops_name,
                                            procs=mesh.processes)

    return loglik


def _build_time_sharded_soa_loglik(spec, obs, times, ids, mesh: Mesh,
                                   axis: str, *, dtype, device):
    """The time-sharded twin: the SoA system and elements of the whole
    sequence on the model's device (ops/kalman_soa._ctcrw_system,
    ops/diag_fused.diag_system), scanned by
    parallel/time_scan.soa_sharded_prefix_scan, the likelihood recovered
    elementwise. Plain tensor arithmetic, so torch.func runs through it."""
    from smoothsde_tpu_torch.infer.objective import twin_route
    from smoothsde_tpu_torch.ops import diag_fused as df
    from smoothsde_tpu_torch.ops.kalman_soa import (
        _ID1,
        _ID2,
        _comb1,
        _combine2,
        _ctcrw_system,
        _llk_from_filtered,
        prepare_ctcrw_data,
    )
    from smoothsde_tpu_torch.parallel.time_scan import soa_sharded_prefix_scan

    # a chunk's local scan: the flat twin's SoA scan on a card, the
    # log-depth "associative" on the CPU (the flat CPU twin's "track" is
    # no scan of elements)
    n = len(ids)
    lo, start, sizes = process_rows(n, mesh)
    hi = start + sum(sizes)
    dev0 = mesh.devices[0]
    local = twin_route(dev0, sizes[0]) if dev0.type == "cuda" \
        else "associative"
    if spec.type == "CTCRW":
        data = prepare_ctcrw_data(obs, times, ids, dtype=dtype, device=device)
    else:
        data = df.prepare_diag_data(spec.type, obs, times, ids, dtype=dtype,
                                    device=device)

    def mine(sys, update):
        """The system's leaves cut to this process's rows (all of them on
        one process), the update mask off at the step before its own."""
        sys = _step_rows(sys, lo, hi)
        mask = getattr(sys, update)
        if lo < start:
            mask = torch.cat([torch.zeros_like(mask[:1]), mask[1:]])
        return sys._replace(**{update: mask})

    def loglik(full, par_full):
        sobs = torch.exp(full["log_sigma_obs"][0])
        if spec.type == "CTCRW":
            sys = mine(_ctcrw_system(
                par_full, None, None, None, sobs, dt=data.dtv, yd=data.yd,
                reset=data.resetf > 0.5, valid=data.validf > 0.5), "update")
            scanned = soa_sharded_prefix_scan(_combine2, _ID2, sys.elem, mesh,
                                              axis, local, n)
            return _llk_from_filtered(sys, scanned.b, scanned.C)
        sysd = mine(df.diag_system(spec.type, par_full, None, None, None,
                                   sobs, data=data), "updatef")
        _, bf, Cf, _, _ = soa_sharded_prefix_scan(
            _comb1, _ID1, df.diag_elements(sysd), mesh, axis, local, n)
        return df.diag_llk_from_filtered(sysd, bf, Cf)

    return loglik


def _step_rows(x, lo: int, hi: int):
    """Every tensor leaf with a step axis (the last) of a system pytree
    cut to the steps [lo, hi); 0-d tensors and numbers as they are."""
    if isinstance(x, tuple):
        leaves = [_step_rows(v, lo, hi) for v in x]
        return type(x)(*leaves) if hasattr(x, "_fields") else tuple(leaves)
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        return x[..., lo:hi]
    return x
