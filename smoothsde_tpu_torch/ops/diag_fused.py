"""Fused scalar-state (BM_SSM / OU_SSM) filter and Fisher-identity
backward: host side, plain versions, and the wrappers of the CUDA kernels.

Port of smoothsde_tpu/ops/diag_fused.py. Per response dim the state is a
scalar: the filtering elements are 5 scalars (A, b, C, eta, J, combined
by `_comb1`), the smoothing elements 3 (E, g, L, combined by
`_comb1_rev`). Model conventions follow the JAX package's
`diag_ssm_loglik_soa`: slot i holds the transition ENTERING step i
(t_i, q_i, c_i), frozen (t = 1, q = c = 0) across each track's first
interval; observation y_i = x_i + N(0, h); prior N(y_s, p0) at each
track start (nllk_bm_ssm.hpp:127-175, nllk_ou_ssm.hpp:163-213).

The block geometry is ops/ctcrw_fused.py's `Plan`: lane `dd * NB + b`
owns the steps b*L .. b*L + L - 1 of dim dd, and every per-step input
lives in one time-major stack (L, k, lanes). Two stacks:

    forward  (L, 6, lanes): 0 t  1 q  2 c  3 y  4 rst  5 upd
    backward (L, 8, lanes): 0 tn 1 qn 2 cn 3 te 4 tvn 5 y 6 upd 7 rst

(tn, qn, cn: the transition LEAVING slot i; te: track end; tvn: that
transition has a density), and the filtered moments (L, 2, lanes): b, C.
Padding past n holds t = 1 and zeros elsewhere, which makes identity
filtering elements and, with the real filter states the forward leaves
in the padded moment slots, identity smoothing elements (G = 1, g = 0,
L = 0). A zero t would give G = 0/0 in the backward, and the reverse
suffix would carry the NaN into every earlier block of the dim.

The four kernels, each with its plain PyTorch version here (the cross-
block prefix is ops/ctcrw_fused.py's K2 wrapper, with the "diag_filter"
and "diag_smooth" elements):

  diag_filter_totals  (D1a)  block totals of the 5-comp filtering elements
                             (and, on the card, its segments' totals)
  diag_filter_scan    (D1b)  prefix-seeded rescan: moments + llk partials
  diag_smooth_totals  (D3a)  block totals of the 3-comp smoothing elements
  diag_score_scan     (D3b)  suffix-seeded rescan: Fisher score cotangents

A wrapper runs its plain version only for a tensor that lies on the CPU;
for a CUDA tensor it launches its kernel (csrc/diag_*.cu, built by
ops/_kernels.py) or raises. Launches are counted in ops/ctcrw_fused.py's
`LAUNCHES`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.ops.kalman_smooth import _ID1_SM, _comb1_rev
from smoothsde_tpu_torch.ops.kalman_soa import (
    _ID1,
    _comb1,
    _shift,
    _shift_back,
    precompute_dt,
)
from smoothsde_tpu_torch.ops.stable import ou_transition_terms

P0 = 10.0  # prior variance at a track start (R/sde.R:554)

_FWD_PAD = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0)
_BWD_PAD = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
_N_TOT = 5
_N_SM = 3
_N_MOM = 2
_N_COT = 4  # t, q, c, y


# ---------------------------------------------------------------------------
# Per-step system
# ---------------------------------------------------------------------------


class DiagData(NamedTuple):
    """Per-step data at the likelihood boundary, on the working device and
    in the working dtype: yd (d, n) observations with NaN -> 0, dtv (n,)
    intervals, and 0/1 masks (n,): track start, previous slot a track
    start, measurement update (finite first response column, no reset).
    For BM_SSM, yd holds y - g for a reference path g (d, n) and dg
    (d, n) its increments g_i - g_{i-1}; for OU_SSM dg is None."""

    yd: torch.Tensor
    dtv: torch.Tensor
    resetf: torch.Tensor
    prevf: torch.Tensor
    updatef: torch.Tensor
    dg: torch.Tensor = None


def _reference_path(obs):
    """(d, n) last finite observation of each dim at or before each step
    (0 before the first): the BM_SSM centring path."""
    n, d = obs.shape
    idx = np.where(np.isfinite(obs), np.arange(n)[:, None], 0)
    np.maximum.accumulate(idx, axis=0, out=idx)
    return np.nan_to_num(obs[idx, np.arange(d)], nan=0.0).T


def prepare_diag_data(type, obs, times, ids, *, dtype, device) -> DiagData:
    """Build the DiagData of model `type` host-side (NumPy, f64 intervals)
    and move it once.

    BM_SSM data are centred: a reference path g (the last finite
    observation, per dim) is subtracted from y and its increments from
    the drift, in f64 before the cast. A BM state is translation-
    equivariant (t = 1), so the likelihood and every cotangent that
    reaches a parameter (of c, q, y, h) are unchanged, but the states
    stay of the size of a step instead of drifting: over 1M steps of BM
    with drift they reach ~1e4, where f32 keeps ~1e-3 and loses the
    ~0.1-scale residuals the score is made of. (An OU state is not
    translation-equivariant, and stays near its mean anyway.)"""
    if type not in ("BM_SSM", "OU_SSM"):
        raise ValueError(type)
    obs = np.asarray(obs, np.float64)
    ids = np.asarray(ids)
    reset = np.concatenate([[True], ids[1:] != ids[:-1]])
    y = np.nan_to_num(obs, nan=0.0).T
    dg = None
    if type == "BM_SSM":
        g = _reference_path(obs)
        y = y - g
        dg = np.diff(g, axis=1, prepend=g[:, :1])

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float64)).to(
            device=device, dtype=dtype
        )

    return DiagData(
        yd=dev(y),
        dtv=dev(precompute_dt(times, ids)),
        resetf=dev(reset),
        prevf=dev(np.concatenate([[True], reset[:-1]])),
        updatef=dev(np.isfinite(obs[:, 0]) & ~reset),
        dg=None if dg is None else dev(dg),
    )


class DiagSystem(NamedTuple):
    """Per-step scalar system: t, q (n,) and c, yd (d, n) of the entering
    transition, h 0-d, the 0/1 masks (n,) of DiagData, and p0. (The JAX
    package's DiagSystem holds the masks as bools.)"""

    t: torch.Tensor
    q: torch.Tensor
    c: torch.Tensor
    yd: torch.Tensor
    h: torch.Tensor
    resetf: torch.Tensor
    prevf: torch.Tensor
    updatef: torch.Tensor
    p0: float


def diag_transition(type, par_mat, dtv, d):
    """The scalar transition of each step from par_mat (n, n_par) on the
    working scale, the intervals dtv (n,) and d dims, unshifted (row i
    propagates from step i to i + 1): t, q (n,) and the drift b (d, n).
    BM_SSM: t = 1, b = mu dt, q = sigma^2 dt; OU_SSM: from the stable
    `ou_transition_terms` (as the JAX package's `diag_ssm_loglik_soa`),
    not from the `1 - decay**2` form of its `diag_system`, which cancels
    in f32 at small dt/tau; in f64 the two agree to roundoff."""
    mu = par_mat[:, :d]
    if type == "BM_SSM":
        sigma = torch.exp(par_mat[:, d])
        return torch.ones_like(sigma), sigma**2 * dtv, dtv[None, :] * mu.T
    if type == "OU_SSM":
        tau = torch.exp(par_mat[:, d])
        kappa = torch.exp(par_mat[:, d + 1])
        ot = ou_transition_terms(tau, dtv)
        return ot["decay"], kappa * ot["qfac"], ot["bfac"][None, :] * mu.T
    raise ValueError(type)


def diag_system(type, par_mat, obs, times, ids, sigma_obs, p0=P0,
                data: DiagData = None) -> DiagSystem:
    """The shifted/masked per-step scalar system (`diag_transition`) from
    par_mat (n, n_par) on the working scale. Pass `data`
    (prepare_diag_data of the same type) to skip rebuilding the per-step
    data; obs/times/ids are then unused."""
    if data is None:
        data = prepare_diag_data(type, obs, times, ids, dtype=par_mat.dtype,
                                 device=par_mat.device)
    if data.dg is not None and type != "BM_SSM":
        raise ValueError("centred (BM_SSM) data given to an OU_SSM system")
    t_s, q_s, b_s = diag_transition(type, par_mat, data.dtv,
                                    data.yd.shape[0])
    h = torch.as_tensor(sigma_obs, dtype=par_mat.dtype,
                        device=par_mat.device) ** 2
    prev = data.prevf > 0.5
    c = torch.where(prev, 0.0, _shift(b_s))
    if data.dg is not None:
        # x' = x - g: the transition x_i = x_{i-1} + c_i becomes
        # x'_i = x'_{i-1} + c_i - (g_i - g_{i-1})
        c = c - data.dg
    return DiagSystem(
        t=torch.where(prev, 1.0, _shift(t_s, 1.0)),
        q=torch.where(prev, 0.0, _shift(q_s)),
        c=c,
        yd=data.yd, h=h, resetf=data.resetf, prevf=data.prevf,
        updatef=data.updatef, p0=float(p0),
    )


# ---------------------------------------------------------------------------
# Element math (mirrored by csrc/diag_common.cuh)
# ---------------------------------------------------------------------------


def _elem1(t, q, c, y, R, U, h, p0):
    """(A, b, C, eta, J) filtering element of one step, branch-free over
    the 0/1 masks R (reset) and U (update)."""
    S = q + h
    K = q / S
    r = y - c
    prop = (1.0 - R) * (1.0 - U)
    updm = (1.0 - R) * U
    A = updm * (1.0 - K) * t + prop * t
    b = R * y + updm * (c + K * r) + prop * c
    C = R * p0 + updm * (1.0 - K) * q + prop * q
    eta = updm * t * r / S
    J = updm * t * t / S
    return A, b, C, eta, J


def _smooth_elem1(tn, qn, cn, mf, Pf, TE):
    """RTS smoothing element (E, g, L) of one step from its filtered
    moments and its LEAVING transition, absorbing at track ends TE;
    also returns the unmasked gain G."""
    Pp = tn * tn * Pf + qn
    G = Pf * tn / Pp
    g = mf - G * (tn * mf + cn)
    Lm = Pf - G * G * Pp
    nTE = 1.0 - TE
    return (nTE * G, TE * mf + nTE * g, TE * Pf + nTE * Lm), G


def diag_elements(sysd: DiagSystem):
    """Vectorized (A, b, C, eta, J) filtering elements, leaves (d, n):
    the JAX package's `diag_elements` (its `where` form)."""
    t, q, c, yd, h = sysd.t, sysd.q, sysd.c, sysd.yd, sysd.h
    reset = sysd.resetf > 0.5
    update = sysd.updatef > 0.5
    S = q + h
    K = q / S
    r = yd - c
    zero = torch.zeros_like(yd)
    A = torch.where(reset, 0.0, torch.where(update, (1.0 - K) * t, t)) + zero
    b = torch.where(reset, yd, torch.where(update, c + K * r, c))
    C = torch.where(
        reset, sysd.p0, torch.where(update, (1.0 - K) * q, q)
    ) + zero
    eta = torch.where(update, t * r / S, zero)
    J = torch.where(update, t * t / S, zero)
    return (A, b, C, eta, J)


def diag_llk_from_filtered(sysd: DiagSystem, bf, Cf):
    """Predictive log-likelihood from the filtered moments (d, n)."""
    reset = sysd.resetf > 0.5
    a_pred = torch.where(reset, sysd.yd, sysd.t * _shift(bf) + sysd.c)
    P_pred = torch.where(reset, sysd.p0, sysd.t**2 * _shift(Cf) + sysd.q)
    F = P_pred + sysd.h
    u = sysd.yd - a_pred
    terms = torch.where(sysd.updatef > 0.5,
                        -0.5 * (torch.log(F) + u * u / F), 0.0)
    return terms.sum()


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def forward_stack(t, q, c, yd, resetf, updatef, p: cf.Plan):
    return cf.stack_rows([t, q, c, yd, resetf, updatef], _FWD_PAD, p)


def backward_stack(t, q, c, yd, resetf, updatef, p: cf.Plan):
    """Leaving rows and look-ahead masks, as the JAX package's `core_bwd`
    builds them (diag_fused.py:622-640): tn = t[i+1] (1 at the end),
    qn, cn = q, c[i+1] (0 at the end), te = reset[i+1] (1 at the end),
    tvn = (no reset at i+1 nor at i) (0 at the end)."""
    prevf = _shift(resetf, 1.0)
    tv = (1.0 - resetf) * (1.0 - prevf)
    rows = [
        _shift_back(t, 1.0), _shift_back(q), _shift_back(c),
        _shift_back(resetf, 1.0), _shift_back(tv), yd, updatef, resetf,
    ]
    return cf.stack_rows(rows, _BWD_PAD, p)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the four kernels (vectorized over lanes, a
# Python loop over the L steps of a block)
# ---------------------------------------------------------------------------


def _identity(vals, like):
    return tuple(torch.full_like(like, v) for v in vals)


def diag_filter_totals_plain(stack, h, p0):
    """D1a: (5, lanes) composition of each lane's filtering elements."""
    c = _identity(_ID1, stack[0, 0])
    for l in range(stack.shape[0]):
        t, q, cc, y, R, U = stack[l].unbind(0)
        c = _comb1(c, _elem1(t, q, cc, y, R, U, h[0], p0))
    return torch.stack(c)


def diag_filter_scan_plain(stack, prefix, h, p0):
    """D1b: rescan seeded with each lane's exclusive prefix. Returns the
    filtered moments (L, 2, lanes) and per-lane llk partials (lanes,)."""
    c = tuple(prefix.unbind(0))
    hs = h[0]
    acc = torch.zeros_like(stack[0, 0])
    moments = []
    for l in range(stack.shape[0]):
        t, q, cc, y, R, U = stack[l].unbind(0)
        # predictive llk term BEFORE absorbing step l
        a_pred = t * c[1] + cc
        Pp = t * t * c[2] + q
        F = Pp + hs
        u = y - a_pred
        acc = acc + U * (-0.5) * (torch.log(F) + u * u / F)
        c = _comb1(c, _elem1(t, q, cc, y, R, U, hs, p0))
        moments.append(torch.stack([c[1], c[2]]))
    return torch.stack(moments), acc


def diag_smooth_totals_plain(stack, moments):
    """D3a: (3, lanes) reverse composition of each lane's smoothing
    elements."""
    acc = _identity(_ID1_SM, stack[0, 0])
    for l in reversed(range(stack.shape[0])):
        tn, qn, cn, te = stack[l, :4].unbind(0)
        mf, Pf = moments[l].unbind(0)
        e, _ = _smooth_elem1(tn, qn, cn, mf, Pf, te)
        acc = _comb1_rev(acc, e)
    return torch.stack(acc)


def diag_score_scan_plain(stack, moments, suffix, h, p0):
    """D3b: rescan in reverse time seeded with each lane's exclusive
    suffix, emitting the Fisher-identity score per slot in LEAVING
    indexing, (L, 4, lanes) rows (t, q, c, y), and per-lane h score
    partials (lanes,). The gbar scaling is applied outside."""
    L = stack.shape[0]
    hs = h[0]
    acc = tuple(suffix.unbind(0))
    ha = torch.zeros_like(stack[0, 0])
    cots = [None] * L
    for l in reversed(range(L)):
        tn, qn, cn, te, TVn, y, U, R = stack[l].unbind(0)
        mf, Pf = moments[l].unbind(0)
        ms1, Ps1 = acc[1], acc[2]  # smoothed at l + 1
        e, G = _smooth_elem1(tn, qn, cn, mf, Pf, te)
        acc = _comb1_rev(acc, e)
        ms, Ps = acc[1], acc[2]  # smoothed at l

        qs = TVn * qn + (1.0 - TVn)  # sanitized q inverse
        qi = 1.0 / qs
        C = Ps1 * G  # lag-one Cov(x_{l+1}, x_l | y)
        Exx = Ps + ms * ms
        Ex2x1 = C + ms1 * ms
        rb = ms1 - tn * ms - cn
        tb = qi * (Ex2x1 - tn * Exx - cn * ms)
        cb = qi * rb
        Err = Ps1 + tn * tn * Ps - 2.0 * tn * C + rb * rb
        qb = 0.5 * (qi * Err * qi - qi)
        # obs + prior score at l (reset prior N(y, p0))
        resid = y - ms
        yb = U * (-resid / hs) + R * (-resid / p0)
        ha = ha + U * (0.5 * (resid * resid + Ps) / (hs * hs) - 0.5 / hs)
        cots[l] = torch.stack([TVn * tb, TVn * qb, TVn * cb, yb])
    return torch.stack(cots), ha


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, CUDA kernel for CUDA tensors
# ---------------------------------------------------------------------------


@functools.cache
def d1b_segs(dtype):
    """D1b's segments (threads) per lane on the card for the working type
    dtype, as the built kernels report it (kD1bSegs in csrc/diag_filter.cu:
    D1a's count in f32, one in f64)."""
    from smoothsde_tpu_torch.ops import _kernels

    return _kernels.constant("diag_filter_segs", dtype)


def segment_scratch(stack):
    """The (S - 1, 5, lanes) scratch, S = d1b_segs of the stack's dtype,
    in which D1a leaves the totals of each lane's segments but the last,
    where D1b's segments start (empty in f64). For a CPU stack it is
    empty: the plain versions take no scratch."""
    segs = d1b_segs(stack.dtype) if stack.is_cuda else 1
    return stack.new_empty((segs - 1, _N_TOT, stack.shape[2]))


def _check_seg(seg, stack, lanes):
    if tuple(seg.shape) != (d1b_segs(stack.dtype) - 1, _N_TOT, lanes):
        raise ValueError(f"segment scratch shape {tuple(seg.shape)}")


def diag_filter_totals(stack, h, p0, seg):
    """D1a wrapper; see diag_filter_totals_plain. On the card D1a also
    fills seg (segment_scratch); for CPU tensors seg is left as it is."""
    if not cf._on_cuda(stack, h, seg):
        return diag_filter_totals_plain(stack, h, p0)
    L, lanes = cf._check_rows(stack, len(_FWD_PAD))
    _check_seg(seg, stack, lanes)
    totals = stack.new_empty((_N_TOT, lanes))
    cf._launch("diag_filter_totals", stack, h, float(p0), totals, seg, L,
               lanes)
    return totals


def diag_filter_scan(stack, prefix, seg, h, p0):
    """D1b wrapper; see diag_filter_scan_plain. On the card seg holds
    D1a's segment totals over the same stack; CPU tensors ignore it."""
    if not cf._on_cuda(stack, prefix, seg, h):
        return diag_filter_scan_plain(stack, prefix, h, p0)
    L, lanes = cf._check_rows(stack, len(_FWD_PAD))
    if tuple(prefix.shape) != (_N_TOT, lanes):
        raise ValueError(f"prefix shape {tuple(prefix.shape)}")
    _check_seg(seg, stack, lanes)
    moments = stack.new_empty((L, _N_MOM, lanes))
    llk = stack.new_empty((lanes,))
    cf._launch("diag_filter_scan", stack, prefix, seg, h, float(p0),
               moments, llk, L, lanes)
    return moments, llk


def diag_smooth_totals(stack, moments):
    """D3a wrapper; see diag_smooth_totals_plain."""
    if not cf._on_cuda(stack, moments):
        return diag_smooth_totals_plain(stack, moments)
    L, lanes = cf._check_rows(stack, len(_BWD_PAD), moments, _N_MOM)
    totals = stack.new_empty((_N_SM, lanes))
    cf._launch("diag_smooth_totals", stack, moments, totals, L, lanes)
    return totals


def diag_score_scan(stack, moments, suffix, h, p0):
    """D3b wrapper; see diag_score_scan_plain."""
    if not cf._on_cuda(stack, moments, suffix, h):
        return diag_score_scan_plain(stack, moments, suffix, h, p0)
    L, lanes = cf._check_rows(stack, len(_BWD_PAD), moments, _N_MOM)
    if tuple(suffix.shape) != (_N_SM, lanes):
        raise ValueError(f"suffix shape {tuple(suffix.shape)}")
    cot = stack.new_empty((L, _N_COT, lanes))
    hbar = stack.new_empty((lanes,))
    cf._launch("diag_score_scan", stack, moments, suffix, h, float(p0),
               cot, hbar, L, lanes)
    return cot, hbar


OPS = {
    "kernels": cf.KernelOps(diag_filter_totals, cf.block_prefix,
                            diag_filter_scan, diag_smooth_totals,
                            diag_score_scan),
    # the plain versions take no segment scratch
    "plain": cf.KernelOps(
        lambda stack, h, p0, seg: diag_filter_totals_plain(stack, h, p0),
        cf.block_prefix_plain,
        lambda stack, prefix, seg, h, p0: diag_filter_scan_plain(
            stack, prefix, h, p0),
        diag_smooth_totals_plain, diag_score_scan_plain),
}


# ---------------------------------------------------------------------------
# Forward filter and backward score
# ---------------------------------------------------------------------------


def diag_fwd(stack, h, p: cf.Plan, p0, ops: cf.KernelOps = OPS["kernels"],
             stitch=None):
    """Forward filter: (llk, filtered moments (L, 2, lanes)). h is a
    1-element tensor on the stack's device. `stitch(chunk_total) -> seed`
    ((5, d) each; the JAX package's hook, diag_fused.py:318-331): the
    chunk's total filtering element in, the exclusive prefix of the
    chunks before it out, seeding every block before D1b (D1b's segment
    totals within each lane stay the chunk's own)."""
    seg = segment_scratch(stack)
    totals = ops.filter_totals(stack, h, p0, seg)
    prefix = ops.block_prefix(totals, p.d, "diag_filter", False)
    if stitch is not None:
        seed = stitch(cf.chunk_total(prefix, totals, p.d, "diag_filter"))
        prefix = cf.seed_blocks(seed, prefix, p.d, "diag_filter")
    moments, llk_lanes = ops.filter_scan(stack, prefix, seg, h, p0)
    return llk_lanes.sum(), moments


def diag_bwd(stack, moments, h, p: cf.Plan, p0,
             ops: cf.KernelOps = OPS["kernels"], stitch=None):
    """Backward over the leaving-row stack: per-slot score in LEAVING
    indexing, (c_t, c_q, c_c, c_y) each (d, n), and the h score sum.
    `stitch`: (3, d) smoothing totals in, the suffix of the later chunks
    out (JAX diag_fused.py:517-531)."""
    totals = ops.smooth_totals(stack, moments)
    suffix = ops.block_prefix(totals, p.d, "diag_smooth", True)
    if stitch is not None:
        seed = stitch(cf.chunk_total(suffix, totals, p.d, "diag_smooth",
                                     True))
        suffix = cf.seed_blocks(seed, suffix, p.d, "diag_smooth")
    cot, hbar_lanes = ops.score_scan(stack, moments, suffix, h, p0)
    c_t, c_q, c_c, c_y = cf.unstack(cot, p)
    return c_t, c_q, c_c, c_y, hbar_lanes.sum()


def _make_core(ops_name: str):
    """autograd.Function at the JAX package's `diag_fused_loglik` boundary
    (t, q, c, yd, h, resetf, updatef), built on the op table `ops_name`:
    "kernels" (the wrappers) or "plain" (the plain PyTorch versions)."""

    class _Core(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, q, c, yd, h, resetf, updatef, p0):
            d, n = yd.shape
            p = cf.plan(d, n)
            h1 = h.reshape(1).contiguous()
            stack = forward_stack(t, q, c, yd, resetf, updatef, p)
            llk, moments = diag_fwd(stack, h1, p, p0, OPS[ops_name])
            ctx.save_for_backward(t, q, c, yd, h1, resetf, updatef, moments)
            ctx.plan, ctx.p0, ctx.h_shape = p, p0, h.shape
            return llk

        @staticmethod
        def backward(ctx, gbar):
            t, q, c, yd, h1, resetf, updatef, moments = ctx.saved_tensors
            p = ctx.plan
            stack = backward_stack(t, q, c, yd, resetf, updatef, p)
            c_t, c_q, c_c, c_y, hsum = diag_bwd(stack, moments, h1, p,
                                                ctx.p0, OPS[ops_name])
            # leaving-slot cotangents -> entering indexing (slot i's
            # leaving transition is the entering one of slot i + 1); t and
            # q are shared by the dims
            return (
                gbar * _shift(c_t).sum(0),
                gbar * _shift(c_q).sum(0),
                gbar * _shift(c_c),
                gbar * c_y,
                (gbar * hsum).reshape(ctx.h_shape),
                None, None, None,  # masks are data; p0 is a constant
            )

    _Core.__name__ = _Core.__qualname__ = (
        "DiagFusedCore" if ops_name == "kernels" else "DiagPlainCore"
    )
    return _Core


# Kernel-backed scalar-state log-likelihood: forward = D1a, K2, D1b;
# backward = D3a, K2 (reverse), D3b. Arguments (t (n,), q (n,), c (d, n),
# yd (d, n), h 0-d, resetf (n,), updatef (n,), p0).
DiagFusedCore = _make_core("kernels")
# The same computation through the plain PyTorch versions only.
DiagPlainCore = _make_core("plain")


def diag_fused_loglik(sysd: DiagSystem, core=DiagFusedCore):
    """Log-likelihood of a DiagSystem through `core`, differentiable in
    t, q, c and h (reverse mode)."""
    return core.apply(sysd.t, sysd.q, sysd.c, sysd.yd, sysd.h, sysd.resetf,
                      sysd.updatef, sysd.p0)


def diag_ssm_loglik_fused(type, par_mat, obs, times, ids, sigma_obs,
                          p0=P0, data: DiagData = None):
    """BM_SSM / OU_SSM log-likelihood through the fused kernels with the
    Fisher-identity gradient. par_mat: (n, d+1) for BM_SSM (mu.., log
    sigma), (n, d+2) for OU_SSM (mu.., log tau, log kappa), working
    scale, on the working device; sigma_obs: scalar measurement SD (a
    tensor to differentiate through it). Pass `data` to skip rebuilding
    the per-step data."""
    sysd = diag_system(type, par_mat, obs, times, ids, sigma_obs, p0, data)
    return diag_fused_loglik(sysd)


# ---------------------------------------------------------------------------
# Time-sharded core (JAX diag_fused.py:665-756)
# ---------------------------------------------------------------------------


class DiagChunk(NamedTuple):
    """One time chunk, rows [start, stop) of a DiagData, on its shard's
    device: yd (d, m); resetf, updatef, te, tvn (m,), the look-ahead
    masks te, tvn (backward_stack's) formed on the whole sequence; and
    for the m + 1 transitions that enter the chunk's slots and the slot
    after it (`diag_chunk_rows`): dtv_ext (m + 1,) the intervals of the
    rows they propagate from (start - 1 .. stop - 1), prevf_ext (m + 1,)
    the entered slots' previous-slot-a-start masks (1 past the end), and
    BM_SSM's dg_ext (d, m + 1) (0 past the end; None for OU_SSM)."""

    yd: torch.Tensor
    resetf: torch.Tensor
    updatef: torch.Tensor
    te: torch.Tensor
    tvn: torch.Tensor
    dtv_ext: torch.Tensor
    prevf_ext: torch.Tensor
    dg_ext: torch.Tensor = None


def split_diag_data(data: DiagData, sizes, devices, start: int = 0):
    """The DiagChunks of consecutive chunks of `sizes` steps from step
    `start` on, chunk r on devices[r]."""
    one = data.resetf.new_ones(1)
    tv = (1.0 - data.resetf) * (1.0 - data.prevf)
    te = torch.cat([data.resetf[1:], one])
    tvn = torch.cat([tv[1:], data.resetf.new_zeros(1)])
    dtv_x = torch.cat([one, data.dtv])
    prevf_x = torch.cat([data.prevf, one])
    dg_x = None if data.dg is None else torch.cat(
        [data.dg, data.dg.new_zeros(data.dg.shape[0], 1)], dim=1)
    chunks, s = [], start
    for m, dev in zip(sizes, devices):
        chunks.append(DiagChunk(
            yd=data.yd[:, s:s + m].to(dev),
            resetf=data.resetf[s:s + m].to(dev),
            updatef=data.updatef[s:s + m].to(dev),
            te=te[s:s + m].to(dev), tvn=tvn[s:s + m].to(dev),
            dtv_ext=dtv_x[s:s + m + 1].to(dev),
            prevf_ext=prevf_x[s:s + m + 1].to(dev),
            dg_ext=None if dg_x is None else dg_x[:, s:s + m + 1].to(dev)))
        s += m
    return chunks


def diag_chunk_rows(type, chunk: DiagChunk, par, prev_row):
    """(t, q (m + 1,), c (d, m + 1)): the transitions entering the chunk's
    m slots and the slot after it, as `diag_system` forms them, from its
    par rows (m, n_par) and the par row before it (prev_row, the previous
    chunk's last; any row at the sequence's start, where it is masked).
    The first m are the forward stack's entering rows, the last m the
    backward stack's leaving rows."""
    d = chunk.yd.shape[0]
    t_s, q_s, b_s = diag_transition(type, torch.cat([prev_row[None], par]),
                                    chunk.dtv_ext, d)
    prev = chunk.prevf_ext > 0.5
    c = torch.where(prev, 0.0, b_s)
    if chunk.dg_ext is not None:
        c = c - chunk.dg_ext
    return torch.where(prev, 1.0, t_s), torch.where(prev, 0.0, q_s), c


class TimeShardedDiagCore(torch.autograd.Function):
    """DiagFusedCore over a sequence cut into time chunks, each on its own
    device, stitched exactly (the scalar-state mirror of
    ops/kalman_soa.TimeShardedCtcrwCore). apply(chunks, ops_name, p0, h,
    procs, *rows): `split_diag_data`'s chunks, the op table of OPS, the
    prior variance, h 0-d on the output's device, procs as
    TimeShardedCtcrwCore's, and each chunk's (t, q, c) of
    `diag_chunk_rows` on its device, flattened. Forward: D1a, K2 and the
    chunk totals (5, d), their exclusive prefixes gathered on h's device
    (and across the processes) and composed into each chunk's block
    prefixes before D1b (D1b's segment totals stay the chunk's own).
    Backward: D3a, K2 reversed, the exclusive suffixes, the seeded D3b.
    The score of each transition lands on its leaving side (the rows'
    last m); the entering side (the first m) gets an exact zero, as in
    the JAX core. Returns the llk of the chunks, 0-d on h's device."""

    @staticmethod
    def forward(ctx, chunks, ops_name, p0, h, procs, *rows):
        ops = OPS[ops_name]
        d = chunks[0].yd.shape[0]
        state, totals, pres = [], [], []
        for r, ch in enumerate(chunks):
            t, q, c = rows[3 * r:3 * r + 3]
            p = cf.plan(d, t.shape[0] - 1)
            h1 = h.reshape(1).to(t.device)
            stack = forward_stack(t[:-1], q[:-1], c[:, :-1], ch.yd,
                                  ch.resetf, ch.updatef, p)
            seg = segment_scratch(stack)
            totals.append(ops.filter_totals(stack, h1, p0, seg))
            pres.append(ops.block_prefix(totals[-1], d, "diag_filter", False))
            state.append((p, stack, seg, h1))
        seeds = cf.stitch_seeds_across(cf.chunk_totals(
            pres, totals, d, "diag_filter", False, h.device), "diag_filter",
            False, procs)
        llk, saved = [], []
        for r, ((p, stack, seg, h1), pre) in enumerate(zip(
                state, cf.seed_chunks(seeds, pres, d, "diag_filter"))):
            mom, ll = ops.filter_scan(stack, pre, seg, h1, p0)
            llk.append(ll.sum().to(h.device))
            saved += [*rows[3 * r:3 * r + 3], mom, h1]
        ctx.save_for_backward(*saved)
        ctx.chunks, ctx.plans = chunks, [s[0] for s in state]
        ctx.ops_name, ctx.p0, ctx.h_shape = ops_name, p0, h.shape
        ctx.procs = procs
        return torch.stack(llk).sum()

    @staticmethod
    def backward(ctx, gbar):
        ops = OPS[ctx.ops_name]
        saved = ctx.saved_tensors
        d = ctx.plans[0].d
        state, totals, sufs = [], [], []
        for r, (ch, p) in enumerate(zip(ctx.chunks, ctx.plans)):
            t, q, c, mom, h1 = saved[5 * r:5 * r + 5]
            stack = cf.stack_rows([t[1:], q[1:], c[:, 1:], ch.te, ch.tvn,
                                   ch.yd, ch.updatef, ch.resetf], _BWD_PAD, p)
            totals.append(ops.smooth_totals(stack, mom))
            sufs.append(ops.block_prefix(totals[-1], d, "diag_smooth", True))
            state.append((p, stack, mom, h1))
        seeds = cf.stitch_seeds_across(cf.chunk_totals(
            sufs, totals, d, "diag_smooth", True, gbar.device),
            "diag_smooth", True, ctx.procs)
        grads, hbars = [], []
        for (p, stack, mom, h1), suf in zip(
                state, cf.seed_chunks(seeds, sufs, d, "diag_smooth")):
            cot, hb = ops.score_scan(stack, mom, suf, h1, ctx.p0)
            c_t, c_q, c_c, _ = cf.unstack(cot, p)
            g = gbar.to(stack.device)
            zero = c_c.new_zeros(d, 1)
            grads += [torch.cat([zero[0], g * c_t.sum(0)]),
                      torch.cat([zero[0], g * c_q.sum(0)]),
                      torch.cat([zero, g * c_c], dim=1)]
            hbars.append((g * hb.sum()).to(gbar.device))
        return (None, None, None,
                torch.stack(hbars).sum().reshape(ctx.h_shape), None, *grads)


def diag_fused_core_time_sharded(rows, chunks, h, ops_name="kernels",
                                 p0=P0, *, procs=None):
    """The time-sharded BM_SSM / OU_SSM log-likelihood (JAX
    diag_fused.py:665), differentiable in each chunk's (t, q, c) rows
    (`diag_chunk_rows`, flattened) and in h: see TimeShardedDiagCore."""
    return TimeShardedDiagCore.apply(chunks, ops_name, float(p0), h, procs,
                                     *rows)
