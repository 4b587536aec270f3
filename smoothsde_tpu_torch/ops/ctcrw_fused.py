"""Fused CTCRW filter and Fisher-identity backward: host side, plain
versions, and the wrappers of the CUDA kernels.

Port of smoothsde_tpu/ops/ctcrw_fused.py (par-space path). The time
axis is cut into `NB` contiguous blocks per response dim; lane
`dd * NB + b` owns block b of dim dd, i.e. the global steps
b*L .. b*L + L - 1. Every per-step input lives in ONE stacked tensor
`(L, 10, lanes)`, time-major within blocks, so the thread that owns a
lane reads neighbouring addresses with its warp at every step. Rows:

    0 lt   log tau        (slot i = par of the transition LEAVING i)
    1 ln   log nu
    2 dtv  interval i -> i+1 (host f64-derived)
    3 mu   drift target of this lane's dim
    4 te   track end
    5 tvn  transition i -> i+1 has a density
    6 y    observation (NaN -> 0)
    7 upd  measurement update at i
    8 rst  track start at i
    9 live 1 on real slots, 0 on padding

The same stack serves the forward and the backward (the forward feeds
each step the PREVIOUS slot's par, carried across steps and seeded per
lane from the boundary rows `bd`; the backward feeds each slot its own).

The element-space path (the JAX package's `fused_filter` and
`fused_backward`) reads the transition already built by
`_ctcrw_system` instead of rebuilding it from par, in two stacks of the
same lane layout:

    forward  (L, 10, lanes): f01 f11 q00 q01 q11 c0 c1 y rst upd
             (the transition ENTERING slot i)
    backward (L, 12, lanes): fn01 fn11 qn00 qn01 qn11 cn0 cn1 te tvn y
             upd rst (the transition LEAVING slot i)

padded with f11 = 1 (fn11 = 1) and zeros elsewhere, which makes identity
filtering and smoothing elements.

The kernels, each with its plain PyTorch version here:

  filter_totals       (K1a)  block totals of the 14-comp filtering elements
  block_prefix        (K2)   exclusive cross-block prefix (suffix if reverse)
  filter_scan         (K1b)  prefix-seeded rescan: moments + llk partials
  smooth_totals       (K3a)  block totals of the 9-comp smoothing elements
  score_scan          (K3b)  suffix-seeded rescan: Fisher score cotangents
  elem_filter_totals  (K4a)  K1a over the element-space forward stack
  elem_filter_scan    (K4b)  K1b over the element-space forward stack
  elem_smooth_totals  (K5a)  K3a over the element-space backward stack
  elem_score_scan     (K5b)  K3b without the par chain rule: the 8
                             element-space cotangent rows and h

(K8, the generic phase-1 scan, lives in ops/scan_utils.py; K2 and K8
take every element kind of `ELEMS`, the square-root ones of
ops/kalman_sqrt.py included.) A wrapper
runs its plain version only for a tensor that lies on the CPU; for a
CUDA tensor it launches its kernel (csrc/, built by ops/_kernels.py) or
raises. Each wrapper counts its launches in `LAUNCHES`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from smoothsde_tpu_torch.ops.kalman_smooth import (
    _ID1_SM,
    _ID_S2,
    Smooth2,
    _comb1_rev,
    _combine2_rev,
)
from smoothsde_tpu_torch.ops.kalman_sqrt import (
    _ID_SQ1,
    _ID_SQ2,
    SqrtElement1,
    SqrtElement2,
    _combine_sqrt1,
    _combine_sqrt2,
)
from smoothsde_tpu_torch.ops.kalman_soa import (
    _ID1,
    _ID2,
    Element2,
    _comb1,
    _combine2,
    _shift,
    _shift_back,
)
from smoothsde_tpu_torch.ops.stable import em1, phi, psi

# Steps per lane the geometry aims for. At 1M steps and d = 2 this gives
# NB = 31,250 blocks, L = 32 and 62,500 lanes (one thread each, ~470 per
# SM of the H100's 132): a short serial chain per thread. Fewer steps per
# lane would fill the card better and give K2 more blocks to scan.
STEPS_PER_LANE = 32
# Blocks per tile of K2's multi-block scan (kPrefixTile in
# csrc/block_prefix.cu, which refuses a scratch sized for another tile).
PREFIX_TILE = 256
# K2's run design for the square-root kinds (csrc/block_prefix.cu
# kRunThreads, kRun): a tile of PREFIX_RUN_THREADS threads, each owning
# PREFIX_RUN consecutive blocks.
PREFIX_RUN_KINDS = ("sqrt2", "sqrt1")
PREFIX_RUN_THREADS = 128
PREFIX_RUN = 4

_PAR_ROWS = 10
_N_BD = 5  # boundary rows: prev lt, ln, dt, mu, rst per lane
_N_TOT = 14  # filtering element: A(4) b(2) C(3) eta(2) J(3)
_N_SM = 9  # smoothing element: E(4) g(2) L(3)
_N_MOM = 5  # filtered moments: m0, m1, P00, P01, P11
_N_COT = 4  # cotangents: mu, log tau, log nu, y
# element-space stacks (see the module docstring) and their padding
_ELEM_FWD_PAD = (0.0, 1.0) + (0.0,) * 8
_ELEM_BWD_PAD = (0.0, 1.0) + (0.0,) * 10
_N_ECOT = 8  # cotangents: f01, f11, q00, q01, q11, c0, c1, y


class Plan(NamedTuple):
    """Block geometry shared by the forward and the backward."""

    d: int
    n: int
    NB: int  # blocks per response dim
    L: int  # steps per block (lane)
    lanes: int  # d * NB


def plan(d: int, n: int) -> Plan:
    NB = max(1, -(-n // STEPS_PER_LANE))
    L = -(-n // NB)
    return Plan(d=d, n=n, NB=NB, L=L, lanes=d * NB)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def _to_lanes(x, p: Plan):
    """(k, d, n) -> (L, k, lanes), zero-padded past n."""
    k = x.shape[0]
    pad = p.NB * p.L - p.n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(k, p.d, p.NB, p.L).permute(3, 0, 1, 2)
    return x.reshape(p.L, k, p.lanes).contiguous()


def unstack(x, p: Plan):
    """Inverse of the stack layout for kernel outputs:
    (L, k, lanes) -> (k, d, n)."""
    k = x.shape[1]
    x = x.reshape(p.L, k, p.d, p.NB).permute(1, 2, 3, 0)
    return x.reshape(k, p.d, p.NB * p.L)[:, :, : p.n]


def pad_to_lanes(x, pad_vals, p: Plan):
    """(k, d, n) -> (L, k, lanes), padded past n with pad_vals[i] in row
    i."""
    pad = p.NB * p.L - p.n
    if pad:
        fill = _const(pad_vals, x)
        x = torch.cat([x, fill.view(-1, 1, 1).expand(x.shape[0], p.d, pad)],
                      dim=-1)
    return _to_lanes(x, p._replace(n=p.NB * p.L))


def stack_rows(rows, pad_vals, p: Plan):
    """(L, k, lanes) stack of rows, each (n,) or (d, n), padded past n
    with pad_vals[i] in row i."""
    return pad_to_lanes(torch.stack([r.expand(p.d, p.n) for r in rows]),
                        pad_vals, p)


def build_par_stack(mu, lt, ln, dtv, te, tvn, yd, upd, rst, p: Plan,
                    ent=None):
    """The shared par-space stack (L, 10, lanes) and the per-lane
    boundary rows bd (5, lanes): the PREVIOUS slot's (lt, ln, dt, mu,
    rst) for each lane's first step (step b*L - 1, the last step of the
    lane before). Lane 0 of each dim is masked by rst = 1 (the first
    step's entering transition is the identity) unless `ent` gives the
    slot before the sequence: (lt, ln, dt, rst) 0-d and mu (d,), the
    last slot of the previous time chunk (JAX kalman_soa.py:726-738 takes
    it from globally shifted copies), so that lane 0 sees the real
    transition across the chunk edge. mu and yd are (d, n); the other
    rows (n,)."""
    d, n = p.d, p.n
    rows = [lt, ln, dtv, mu, te, tvn, yd, upd, rst, torch.ones_like(lt)]
    stack = _to_lanes(torch.stack([r.expand(d, n) for r in rows]), p)
    start = torch.arange(p.NB, device=lt.device) * p.L
    bidx = (start - 1).clamp(0, n - 1)
    rst_b = torch.where(start == 0, 1.0, rst[bidx]).to(lt.dtype)
    b_rows = [lt[bidx], ln[bidx], dtv[bidx], rst_b]
    mu_b = mu[:, bidx]
    if ent is not None:
        e_lt, e_ln, e_dt, e_mu, e_rst = ent
        b_rows = [torch.cat([e.reshape(1), x[1:]])
                  for e, x in zip((e_lt, e_ln, e_dt, e_rst), b_rows)]
        mu_b = torch.cat([e_mu.reshape(d, 1), mu_b[:, 1:]], dim=1)
    bd = torch.stack([
        b_rows[0].expand(d, p.NB), b_rows[1].expand(d, p.NB),
        b_rows[2].expand(d, p.NB), mu_b, b_rows[3].expand(d, p.NB),
    ]).reshape(_N_BD, p.lanes).contiguous()
    return stack, bd


def par_stack_from_data(par_mat, yd, dtv, resetf, validf, p: Plan):
    """The stack from the likelihood boundary arguments: derives the
    track-end / has-density / update masks from the resets, as the JAX
    package's `_fused_par_core` does (kalman_soa.py:562-573)."""
    d = p.d
    one = resetf.new_ones(1)
    prevf = torch.cat([one, resetf[:-1]])
    updf = validf * (1.0 - resetf)  # validity from the first column only
    te = torch.cat([resetf[1:], one])
    tv = (1.0 - resetf) * (1.0 - prevf)
    tvn = torch.cat([tv[1:], resetf.new_zeros(1)])
    return build_par_stack(
        par_mat[:, :d].T, par_mat[:, d], par_mat[:, d + 1], dtv, te, tvn,
        yd, updf, resetf, p,
    )


# ---------------------------------------------------------------------------
# Element math (mirrored by csrc/ctcrw_common.cuh)
# ---------------------------------------------------------------------------


def _elem_from_vals(f01, f11, q00, q01, q11, c0, c1, y, R, U,
                    p0_pos, p0_vel, h):
    """Filtering element from the entering transition (F rows (1, f01),
    (0, f11); Q; drift c) and the observation: a branch-free three-way
    select between reset, update and propagate-only (0/1 masks R, U)."""
    S = q00 + h
    inv_s = 1.0 / S
    K0 = q00 * inv_s
    K1 = q01 * inv_s
    r = y - c0

    uA00 = 1.0 - K0
    uA01 = (1.0 - K0) * f01
    uA10 = -K1
    uA11 = f11 - K1 * f01
    ub0 = c0 + K0 * r
    ub1 = c1 + K1 * r
    uC00 = (1.0 - K0) * q00
    uC01 = (1.0 - K0) * q01
    uC11 = q11 - K1 * q01
    ue0 = r * inv_s
    ue1 = f01 * r * inv_s
    uJ00 = inv_s
    uJ01 = f01 * inv_s
    uJ11 = f01 * f01 * inv_s

    prop = (1.0 - R) * (1.0 - U)
    updm = (1.0 - R) * U
    A00 = updm * uA00 + prop * 1.0
    A01 = updm * uA01 + prop * f01
    A10 = updm * uA10
    A11 = updm * uA11 + prop * f11
    b0 = R * y + updm * ub0 + prop * c0
    b1 = updm * ub1 + prop * c1
    C00 = R * p0_pos + updm * uC00 + prop * q00
    C01 = updm * uC01 + prop * q01
    C11 = R * p0_vel + updm * uC11 + prop * q11
    return Element2(
        A=((A00, A01), (A10, A11)),
        b=(b0, b1),
        C=((C00, C01), (C01, C11)),
        eta=(updm * ue0, updm * ue1),
        J=((updm * uJ00, updm * uJ01), (updm * uJ01, updm * uJ11)),
    )


def _pack_elem(e: Element2):
    return [
        e.A[0][0], e.A[0][1], e.A[1][0], e.A[1][1],
        e.b[0], e.b[1],
        e.C[0][0], e.C[0][1], e.C[1][1],
        e.eta[0], e.eta[1],
        e.J[0][0], e.J[0][1], e.J[1][1],
    ]


def _unpack_elem_full(v) -> Element2:
    return Element2(
        A=((v[0], v[1]), (v[2], v[3])),
        b=(v[4], v[5]),
        C=((v[6], v[7]), (v[7], v[8])),
        eta=(v[9], v[10]),
        J=((v[11], v[12]), (v[12], v[13])),
    )


_ID_VALS = _pack_elem(_ID2)


def _pack_sm(e: Smooth2):
    return [
        e.E[0][0], e.E[0][1], e.E[1][0], e.E[1][1],
        e.g[0], e.g[1],
        e.L[0][0], e.L[0][1], e.L[1][1],
    ]


def _unpack_sm(v) -> Smooth2:
    return Smooth2(
        E=((v[0], v[1]), (v[2], v[3])),
        g=(v[4], v[5]),
        L=((v[6], v[7]), (v[7], v[8])),
    )


_ID_SM = _pack_sm(_ID_S2)


def _par_terms_vals(lt, ln, dtv, m, R):
    """Transition pieces from raw par values, identity-masked where
    R = 1. Padding slots (lt = ln = dtv = m = 0) evaluate to the
    identity element with no extra masking (u = 0 -> e1 = 1, em1 = 0,
    phi = psi = 0). Uses the expm1-based em1/psi/phi, as the CUDA
    kernels do."""
    tau = torch.exp(lt)
    beta = 1.0 / tau
    nu = torch.exp(ln)
    sigma2 = 4.0 * nu * nu / (math.pi * tau)
    u = beta * dtv
    e1 = torch.exp(-u)
    m1 = em1(u)
    psi_u = psi(u)
    phi_u = phi(u)
    g = m1 / beta
    s3 = sigma2 / (beta * beta * beta)
    s2 = sigma2 / (2.0 * beta * beta)
    s1 = sigma2 / (2.0 * beta)
    q00 = s3 * phi_u
    q01 = s2 * (m1 * m1)
    q11 = s1 * (m1 * (1.0 + e1))
    bp = psi_u / beta
    bv = m1
    nR = 1.0 - R
    return dict(
        f01=nR * g, f11=R + nR * e1,
        q00=nR * q00, q01=nR * q01, q11=nR * q11,
        c0=nR * bp * m, c1=nR * bv * m,
        # unmasked intermediates for the chain rule (tvn masks the
        # score, and tvn = 0 wherever R = 1)
        u=u, e1=e1, m1=m1, g=g, bp=bp, bv=bv, dtv=dtv, m=m,
        s1=s1, s2=s2, s3=s3, uq00=q00, uq01=q01, uq11=q11,
    )


def _smooth_elem_vals(f01, f11, q00, q01, q11, c0, c1,
                      m0, m1, P00, P01, P11, TE):
    """RTS smoothing element at a step from its filtered moments and
    its LEAVING transition; absorbing (smoothed = filtered) at track
    ends TE. Returns (Smooth2, G) with G the unmasked RTS gain."""
    Pp00 = P00 + 2.0 * f01 * P01 + f01 * f01 * P11 + q00
    Pp01 = f11 * (P01 + f01 * P11) + q01
    Pp11 = f11 * f11 * P11 + q11
    det = Pp00 * Pp11 - Pp01 * Pp01
    i00 = Pp11 / det
    i01 = -Pp01 / det
    i11 = Pp00 / det
    PF00 = P00 + f01 * P01
    PF01 = f11 * P01
    PF10 = P01 + f01 * P11
    PF11 = f11 * P11
    G00 = PF00 * i00 + PF01 * i01
    G01 = PF00 * i01 + PF01 * i11
    G10 = PF10 * i00 + PF11 * i01
    G11 = PF10 * i01 + PF11 * i11
    u0 = m0 + f01 * m1 + c0
    u1 = f11 * m1 + c1
    g0 = m0 - (G00 * u0 + G01 * u1)
    g1 = m1 - (G10 * u0 + G11 * u1)
    GP00 = G00 * Pp00 + G01 * Pp01
    GP01 = G00 * Pp01 + G01 * Pp11
    GP10 = G10 * Pp00 + G11 * Pp01
    GP11 = G10 * Pp01 + G11 * Pp11
    L00 = P00 - (GP00 * G00 + GP01 * G01)
    L01 = P01 - (GP00 * G10 + GP01 * G11)
    L11 = P11 - (GP10 * G10 + GP11 * G11)

    nTE = 1.0 - TE
    elem = Smooth2(
        E=((nTE * G00, nTE * G01), (nTE * G10, nTE * G11)),
        g=(TE * m0 + nTE * g0, TE * m1 + nTE * g1),
        L=(
            (TE * P00 + nTE * L00, TE * P01 + nTE * L01),
            (TE * P01 + nTE * L01, TE * P11 + nTE * L11),
        ),
    )
    return elem, (G00, G01, G10, G11)


def _pred_llk(c: Element2, f01, c0, q00, y, U, hs):
    """Predictive log-likelihood term of a step from the carry BEFORE the
    step absorbs it (its filtered moments at the previous step) and the
    entering transition; 0 unless U."""
    a_pred = c.b[0] + f01 * c.b[1] + c0
    Pp00 = c.C[0][0] + 2.0 * f01 * c.C[0][1] + f01 * f01 * c.C[1][1] + q00
    F = Pp00 + hs
    u = y - a_pred
    return U * (-0.5) * (torch.log(F) + u * u / F)


def _transition_score(f01, f11, q00, q01, q11, c0, c1, TVn, nxt: Smooth2,
                      cur: Smooth2, G):
    """Fisher-identity score of the transition LEAVING a step (rows
    (1, f01), (0, f11) of F, Q, c), unmasked: (Fb01, Fb11, Qb00, Qb01,
    Qb11, cb0, cb1). nxt / cur are the smoothing accumulators holding
    the smoothed moments at the next step and at this one; G is the
    unmasked RTS gain; TVn = 0 sanitizes Q where the transition has no
    density (the caller masks the score with TVn)."""
    ms1_0, ms1_1 = nxt.g
    Ps1_00, Ps1_01 = nxt.L[0]
    Ps1_11 = nxt.L[1][1]
    ms0, ms1 = cur.g
    Ps00, Ps01 = cur.L[0]
    Ps11 = cur.L[1][1]
    # sanitized Qn inverse
    q00 = TVn * q00 + (1.0 - TVn)
    q01 = TVn * q01
    q11 = TVn * q11 + (1.0 - TVn)
    det = q00 * q11 - q01 * q01
    qi00 = q11 / det
    qi01 = -q01 / det
    qi11 = q00 / det

    # lag-one Cov(x_{i+1}, x_i | y) = P_s_{i+1} G'
    C00 = Ps1_00 * G[0] + Ps1_01 * G[1]
    C01 = Ps1_00 * G[2] + Ps1_01 * G[3]
    C10 = Ps1_01 * G[0] + Ps1_11 * G[1]
    C11 = Ps1_01 * G[2] + Ps1_11 * G[3]
    Exx01 = Ps01 + ms0 * ms1
    Exx11 = Ps11 + ms1 * ms1
    Ex2x01 = C01 + ms1_0 * ms1
    Ex2x11 = C11 + ms1_1 * ms1
    # r = m_{i+1} - Fn m_i - cn ; Fn rows (1, f01), (0, f11)
    r0 = ms1_0 - (ms0 + f01 * ms1) - c0
    r1 = ms1_1 - f11 * ms1 - c1

    # Fbar = Qinv (Ex2x1 - Fn Exx - cn m_i'), second column
    T01 = Ex2x01 - (Exx01 + f01 * Exx11) - c0 * ms1
    T11 = Ex2x11 - f11 * Exx11 - c1 * ms1
    Fb01 = qi00 * T01 + qi01 * T11
    Fb11 = qi01 * T01 + qi11 * T11
    # cbar = Qinv r
    cb0 = qi00 * r0 + qi01 * r1
    cb1 = qi01 * r0 + qi11 * r1
    # E[r r'] = P_{i+1} + Fn P_i Fn' - C Fn' - Fn C' + r r'
    FP00 = Ps00 + 2.0 * f01 * Ps01 + f01 * f01 * Ps11
    FP01 = f11 * (Ps01 + f01 * Ps11)
    FP11 = f11 * f11 * Ps11
    CF00 = C00 + f01 * C01
    CF01 = f11 * C01
    CF10 = C10 + f01 * C11
    CF11 = f11 * C11
    E00 = Ps1_00 + FP00 - 2.0 * CF00 + r0 * r0
    E01 = Ps1_01 + FP01 - CF01 - CF10 + r0 * r1
    E11 = Ps1_11 + FP11 - 2.0 * CF11 + r1 * r1
    # Qbar = 0.5 (Qinv Errt Qinv - Qinv)
    A00 = qi00 * E00 + qi01 * E01
    A01 = qi00 * E01 + qi01 * E11
    A10 = qi01 * E00 + qi11 * E01
    A11 = qi01 * E01 + qi11 * E11
    Qb00 = 0.5 * ((A00 * qi00 + A01 * qi01) - qi00)
    Qb01 = 0.5 * ((A00 * qi01 + A01 * qi11) - qi01)
    Qb11 = 0.5 * ((A10 * qi01 + A11 * qi11) - qi11)
    return Fb01, Fb11, Qb00, Qb01, Qb11, cb0, cb1


def _obs_score(y, cur: Smooth2, U, R, hs, p0_pos):
    """Observation + track-start prior score at a step from its smoothed
    moments: (y cotangent, h score term)."""
    resid = y - cur.g[0]
    yb = U * (-resid / hs) + R * (-resid / p0_pos)
    Ey2 = resid * resid + cur.L[0][0]
    return yb, U * (0.5 * Ey2 / (hs * hs) - 0.5 / hs)


def _step_elem(rows, pv, h, p0_pos, p0_vel):
    """(element, transition terms, new prev-par) for one step given its
    stack rows and the previous slot's par pv = (lt, ln, dt, mu, rst)."""
    lt, ln, dtv, mu, _te, _tvn, y, upd, rst, live = rows
    # transition entering l = transition leaving l-1; identity when l-1
    # was a reset OR l is padding (the prev carry would otherwise drag
    # the last real transition into the pads)
    Rm = 1.0 - live * (1.0 - pv[4])
    w = _par_terms_vals(pv[0], pv[1], pv[2], pv[3], Rm)
    e = _elem_from_vals(
        w["f01"], w["f11"], w["q00"], w["q01"], w["q11"],
        w["c0"], w["c1"], y, rst, upd, p0_pos, p0_vel, h,
    )
    return e, w, (lt, ln, dtv, mu, rst)


def _identity(vals, like):
    return [torch.full_like(like, v) for v in vals]


def _const(vals, like):
    """vals as a (k,) tensor of like's dtype and device: one host copy,
    or fills on the device while a CUDA graph is being captured (a
    capture refuses host copies; the Laplace layer captures the twin,
    whose "blocked" scan pads and prefixes through here)."""
    if like.is_cuda and torch.cuda.is_current_stream_capturing():
        return torch.stack(_identity(vals, like.new_empty(())))
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the five kernels (vectorized over lanes,
# a Python loop over the L steps of a block)
# ---------------------------------------------------------------------------


def filter_totals_plain(stack, bd, h, p0_pos, p0_vel):
    """K1a: (14, lanes) composition of each lane's filtering elements."""
    c = _unpack_elem_full(_identity(_ID_VALS, bd[0]))
    pv = tuple(bd.unbind(0))
    for l in range(stack.shape[0]):
        e, _, pv = _step_elem(stack[l].unbind(0), pv, h[0], p0_pos, p0_vel)
        c = _combine2(c, e)
    return torch.stack(_pack_elem(c))


def filter_scan_plain(stack, bd, prefix, h, p0_pos, p0_vel):
    """K1b: rescan seeded with each lane's exclusive prefix. Returns the
    filtered moments (L, 5, lanes) and per-lane llk partials (lanes,)."""
    L = stack.shape[0]
    c = _unpack_elem_full(prefix.unbind(0))
    pv = tuple(bd.unbind(0))
    hs = h[0]
    acc = torch.zeros_like(bd[0])
    moments = []
    for l in range(L):
        rows = stack[l].unbind(0)
        e, w, pv = _step_elem(rows, pv, hs, p0_pos, p0_vel)
        acc = acc + _pred_llk(c, w["f01"], w["c0"], w["q00"], rows[6],
                              rows[7], hs)
        c = _combine2(c, e)
        moments.append(torch.stack(
            [c.b[0], c.b[1], c.C[0][0], c.C[0][1], c.C[1][1]]
        ))
    return torch.stack(moments), acc


def _pack_sqrt2(e: SqrtElement2):
    """14 components: A (4), b (2), U (3), eta (2), Z (3)."""
    return [e.A[0][0], e.A[0][1], e.A[1][0], e.A[1][1], *e.b, *e.U, *e.eta,
            *e.Z]


def _unpack_sqrt2(v) -> SqrtElement2:
    return SqrtElement2(((v[0], v[1]), (v[2], v[3])), (v[4], v[5]),
                        (v[6], v[7], v[8]), (v[9], v[10]),
                        (v[11], v[12], v[13]))


class _ElemKind(NamedTuple):
    combine: Callable
    pack: Callable
    unpack: Callable
    id_vals: list


ELEMS = {
    "filter": _ElemKind(_combine2, _pack_elem, _unpack_elem_full, _ID_VALS),
    "smooth": _ElemKind(_combine2_rev, _pack_sm, _unpack_sm, _ID_SM),
    # scalar-state elements of BM_SSM / OU_SSM (ops/diag_fused.py)
    "diag_filter": _ElemKind(_comb1, list, tuple, list(_ID1)),
    "diag_smooth": _ElemKind(_comb1_rev, list, tuple, list(_ID1_SM)),
    # square-root elements (ops/kalman_sqrt.py)
    "sqrt2": _ElemKind(_combine_sqrt2, _pack_sqrt2, _unpack_sqrt2,
                       _pack_sqrt2(_ID_SQ2)),
    "sqrt1": _ElemKind(_combine_sqrt1, list, lambda v: SqrtElement1(*v),
                       list(_ID_SQ1)),
}


def block_prefix_plain(totals, d, elem, reverse):
    """K2: exclusive prefix (suffix if reverse) of the per-block totals
    (C, lanes) along the blocks of each response dim, with identity
    fill. Hillis-Steele over the NB blocks; `combine(a, b)` always has
    `a` first in scan order (for the reverse smoother combine,
    `_combine2_rev(acc, new)`, acc is the LATER segment in time)."""
    k_ = ELEMS[elem]
    C, lanes = totals.shape
    NB = lanes // d
    x = totals.reshape(C, d, NB)
    if reverse:
        x = x.flip(-1)
    ident = _const(k_.id_vals, x)

    def fill(k):
        return ident.view(C, 1, 1).expand(C, d, k)

    k = 1
    while k < NB:
        sh = torch.cat([fill(k), x[..., :-k]], dim=-1)
        x = torch.stack(k_.pack(k_.combine(
            k_.unpack(sh.unbind(0)), k_.unpack(x.unbind(0))
        )))
        k *= 2
    ex = torch.cat([fill(1), x[..., :-1]], dim=-1)
    if reverse:
        ex = ex.flip(-1)
    return ex.reshape(C, lanes).contiguous()


def _par_smooth_elem(lt, ln, dtv, mu, te, R, mom):
    """(transition terms, smoothing element, unmasked RTS gain) of a step
    from its own par (the transition LEAVING it) and its filtered moments
    mom = (m0, m1, P00, P01, P11)."""
    w = _par_terms_vals(lt, ln, dtv, mu, R)
    e, G = _smooth_elem_vals(w["f01"], w["f11"], w["q00"], w["q01"],
                             w["q11"], w["c0"], w["c1"], *mom, te)
    return w, e, G


def smooth_totals_plain(stack, moments):
    """K3a: (9, lanes) reverse composition of each lane's smoothing
    elements."""
    acc = _unpack_sm(_identity(_ID_SM, stack[0, 0]))
    for l in reversed(range(stack.shape[0])):
        lt, ln, dtv, mu, te = stack[l, :5].unbind(0)
        _, e, _ = _par_smooth_elem(lt, ln, dtv, mu, te, stack[l, 8],
                                   moments[l].unbind(0))
        acc = _combine2_rev(acc, e)
    return torch.stack(_pack_sm(acc))


def score_scan_plain(stack, moments, suffix, h, p0_pos):
    """K3b: rescan in reverse time seeded with each lane's exclusive
    suffix, emitting the Fisher-identity score contracted to (mu,
    log tau, log nu, y) per step, (L, 4, lanes), and the per-lane h
    score partials (lanes,). The gbar scaling is applied outside."""
    L = stack.shape[0]
    hs = h[0]
    acc = _unpack_sm(suffix.unbind(0))
    ha = torch.zeros_like(stack[0, 0])
    cots = [None] * L
    for l in reversed(range(L)):
        lt, ln, dtv, mu, te, TVn, y, U, R = stack[l, :9].unbind(0)
        w, e, G = _par_smooth_elem(lt, ln, dtv, mu, te, R,
                                   moments[l].unbind(0))
        nxt = acc  # smoothed at i+1 is the incoming accumulator
        acc = _combine2_rev(acc, e)  # smoothed at i
        yb, h_term = _obs_score(y, acc, U, R, hs, p0_pos)
        ha = ha + h_term
        cots[l] = _step_cot(w, TVn, nxt, acc, G, yb)
    return torch.stack(cots), ha


def _par_chain_rule(w, Fb01, Fb11, Qb00, Qb01, Qb11, cb0, cb1):
    """The transition score contracted to (mu, log tau, log nu) by the
    par -> (F, Q, c) chain rule, all closed-form (before the TVn mask)."""
    u, e1, m1 = w["u"], w["e1"], w["m1"]
    ue1 = u * e1
    # d/d(log tau): g = tau*em1, e1' = u e1; q terms carry the tau
    # powers of sigma2/beta^k; phi' = em1^2, psi' = em1
    dg = w["g"] - w["dtv"] * e1
    dq00 = 2.0 * w["uq00"] - w["s3"] * u * m1 * m1
    dq01 = w["uq01"] - 2.0 * w["s2"] * m1 * ue1
    dq11 = -2.0 * w["s1"] * ue1 * e1
    dbp = w["bp"] - w["dtv"] * m1
    # q01 feeds BOTH off-diagonal Q entries in the primal -> 2x
    ltb = (Fb01 * dg + Fb11 * ue1
           + Qb00 * dq00 + 2.0 * Qb01 * dq01 + Qb11 * dq11
           + (cb0 * dbp - cb1 * ue1) * w["m"])
    # all Q entries scale as nu^2
    lnb = 2.0 * (Qb00 * w["uq00"] + 2.0 * Qb01 * w["uq01"]
                 + Qb11 * w["uq11"])
    mub = cb0 * w["bp"] + cb1 * w["bv"]
    return mub, ltb, lnb


def _step_cot(w, TVn, nxt: Smooth2, cur: Smooth2, G, yb):
    """K3b's (4, lanes) cotangents of one step: the score of its leaving
    transition (nxt / cur: smoothed at the next step and at this one),
    masked by TVn, then the y cotangent yb."""
    score = _transition_score(w["f01"], w["f11"], w["q00"], w["q01"],
                              w["q11"], w["c0"], w["c1"], TVn, nxt, cur, G)
    mub, ltb, lnb = _par_chain_rule(w, *score)
    return torch.stack([TVn * mub, TVn * ltb, TVn * lnb, yb])


# ---- element-space plain versions (K4a, K4b, K5a, K5b) ----


def elem_filter_totals_plain(stack, h, p0_pos, p0_vel):
    """K4a: (14, lanes) composition of each lane's filtering elements,
    read from the element-space forward stack."""
    c = _unpack_elem_full(_identity(_ID_VALS, stack[0, 0]))
    for l in range(stack.shape[0]):
        c = _combine2(c, _elem_from_vals(*stack[l].unbind(0), p0_pos,
                                         p0_vel, h[0]))
    return torch.stack(_pack_elem(c))


def elem_filter_scan_plain(stack, prefix, h, p0_pos, p0_vel):
    """K4b: rescan seeded with each lane's exclusive prefix: filtered
    moments (L, 5, lanes) and per-lane llk partials (lanes,)."""
    c = _unpack_elem_full(prefix.unbind(0))
    hs = h[0]
    acc = torch.zeros_like(prefix[0])
    moments = []
    for l in range(stack.shape[0]):
        rows = stack[l].unbind(0)
        f01, _, q00, _, _, c0, _, y, _, U = rows
        acc = acc + _pred_llk(c, f01, c0, q00, y, U, hs)
        c = _combine2(c, _elem_from_vals(*rows, p0_pos, p0_vel, hs))
        moments.append(torch.stack(
            [c.b[0], c.b[1], c.C[0][0], c.C[0][1], c.C[1][1]]
        ))
    return torch.stack(moments), acc


def elem_smooth_totals_plain(stack, moments):
    """K5a: (9, lanes) reverse composition of each lane's smoothing
    elements, read from the element-space backward stack."""
    acc = _unpack_sm(_identity(_ID_SM, stack[0, 0]))
    for l in reversed(range(stack.shape[0])):
        e, _ = _smooth_elem_vals(*stack[l, :7].unbind(0),
                                 *moments[l].unbind(0), stack[l, 7])
        acc = _combine2_rev(acc, e)
    return torch.stack(_pack_sm(acc))


def elem_score_scan_plain(stack, moments, suffix, h, p0_pos):
    """K5b: rescan in reverse time seeded with each lane's exclusive
    suffix, emitting per slot the score of the transition LEAVING it and
    of its observation, (L, 8, lanes) rows (f01, f11, q00, q01, q11, c0,
    c1, y), and the per-lane h score partials (lanes,). The gbar scaling
    and the shift to entering indexing happen outside."""
    L = stack.shape[0]
    hs = h[0]
    acc = _unpack_sm(suffix.unbind(0))
    ha = torch.zeros_like(suffix[0])
    cots = [None] * L
    for l in reversed(range(L)):
        rows = stack[l].unbind(0)
        trans, (te, TVn, y, U, R) = rows[:7], rows[7:]
        e, G = _smooth_elem_vals(*trans, *moments[l].unbind(0), te)
        nxt = acc
        acc = _combine2_rev(acc, e)
        score = _transition_score(*trans, TVn, nxt, acc, G)
        yb, h_term = _obs_score(y, acc, U, R, hs, p0_pos)
        ha = ha + h_term
        cots[l] = torch.stack([TVn * s for s in score] + [yb])
    return torch.stack(cots), ha


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, CUDA kernel for CUDA tensors
# ---------------------------------------------------------------------------

# Launch counts per kernel of the port (these wrappers' and those of
# ops/diag_fused.py); each wrapper adds one where it launches.
LAUNCHES = {
    "ctcrw_filter_totals": 0,
    "block_prefix_filter": 0,
    "ctcrw_filter_scan": 0,
    "ctcrw_smooth_totals": 0,
    "block_prefix_smooth": 0,
    "ctcrw_score_scan": 0,
    "diag_filter_totals": 0,
    "block_prefix_diag_filter": 0,
    "diag_filter_scan": 0,
    "diag_smooth_totals": 0,
    "block_prefix_diag_smooth": 0,
    "diag_score_scan": 0,
    "elem_filter_totals": 0,
    "elem_filter_scan": 0,
    "elem_smooth_totals": 0,
    "elem_score_scan": 0,
    "phase1_scan_filter": 0,
    "phase1_scan_smooth": 0,
    "phase1_scan_diag_filter": 0,
    "phase1_scan_diag_smooth": 0,
    "phase1_scan_sqrt2": 0,
    "phase1_scan_sqrt1": 0,
    "block_prefix_sqrt2": 0,
    "block_prefix_sqrt1": 0,
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*ts) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on anything
    else, on mixed devices/dtypes, or when a CUDA input needs a gradient
    (the kernels are forward-only: their gradients come from the
    Fisher-identity backwards, never from autograd through a launch)."""
    dev, dt = ts[0].device, ts[0].dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"kernel inputs must be float32/float64, got {dt}")
    for t in ts:
        if t.device != dev or t.dtype != dt:
            raise ValueError(
                "kernel inputs must share one device and dtype; got "
                f"{[(x.device, x.dtype) for x in ts]}"
            )
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "the CUDA kernels are forward-only: differentiate through an "
            "analytic-gradient core (analytic_grad=True) instead"
        )
    return True


def _check_stack(stack, bd=None, moments=None, rows_min=_PAR_ROWS):
    L, rows, lanes = stack.shape
    if rows < rows_min:
        raise ValueError(f"stack has {rows} rows, needs {rows_min}")
    if bd is not None and tuple(bd.shape) != (_N_BD, lanes):
        raise ValueError(f"bd shape {tuple(bd.shape)} != {(_N_BD, lanes)}")
    if moments is not None and tuple(moments.shape) != (L, _N_MOM, lanes):
        raise ValueError(
            f"moments shape {tuple(moments.shape)} != {(L, _N_MOM, lanes)}"
        )
    return L, lanes


def _check_rows(stack, rows, moments=None, mom_rows=_N_MOM):
    """(L, lanes) of a stack of exactly `rows` rows, and of its moments
    (L, mom_rows, lanes) if given; raises on any other shape."""
    L, k, lanes = stack.shape
    if k != rows:
        raise ValueError(f"stack has {k} rows, needs {rows}")
    want = (L, mom_rows, lanes)
    if moments is not None and tuple(moments.shape) != want:
        raise ValueError(f"moments shape {tuple(moments.shape)} != {want}")
    return L, lanes


def _launch(name, *args):
    """Launch kernel `name` (ops/_kernels.py) and count it."""
    from smoothsde_tpu_torch.ops import _kernels

    _kernels.launch(name, *args)
    LAUNCHES[name] += 1


def filter_totals(stack, bd, h, p0_pos, p0_vel):
    """K1a wrapper; see filter_totals_plain."""
    if not _on_cuda(stack, bd, h):
        return filter_totals_plain(stack, bd, h, p0_pos, p0_vel)
    L, lanes = _check_stack(stack, bd)
    totals = torch.empty((_N_TOT, lanes), dtype=stack.dtype,
                         device=stack.device)
    _launch("ctcrw_filter_totals", stack, bd, h, float(p0_pos),
            float(p0_vel), totals, L, lanes)
    return totals


def filter_scan(stack, bd, prefix, h, p0_pos, p0_vel):
    """K1b wrapper; see filter_scan_plain."""
    if not _on_cuda(stack, bd, prefix, h):
        return filter_scan_plain(stack, bd, prefix, h, p0_pos, p0_vel)
    L, lanes = _check_stack(stack, bd)
    if tuple(prefix.shape) != (_N_TOT, lanes):
        raise ValueError(f"prefix shape {tuple(prefix.shape)}")
    moments = torch.empty((L, _N_MOM, lanes), dtype=stack.dtype,
                          device=stack.device)
    llk = torch.empty((lanes,), dtype=stack.dtype, device=stack.device)
    _launch("ctcrw_filter_scan", stack, bd, prefix, h, float(p0_pos),
            float(p0_vel), moments, llk, L, lanes)
    return moments, llk


def block_prefix(totals, d, elem, reverse):
    """K2 wrapper; see block_prefix_plain. elem: "filter" (14-comp,
    `_combine2`), "smooth" (9-comp, `_combine2_rev`), "diag_filter"
    (5-comp, `_comb1`), "diag_smooth" (3-comp, `_comb1_rev`), "sqrt2"
    (14-comp, `_combine_sqrt2`) or "sqrt1" (5-comp, `_combine_sqrt1`)."""
    if not _on_cuda(totals):
        return block_prefix_plain(totals, d, elem, reverse)
    C, lanes = totals.shape
    if C != len(ELEMS[elem].id_vals) or lanes % d:
        raise ValueError(f"totals shape {tuple(totals.shape)} for {elem}")
    NB = lanes // d
    # the kernel's scratch, columns per dim: the tile totals, and in the
    # run design each thread's exclusive prefix within its tile (the C
    # entry point refuses another count)
    if elem in PREFIX_RUN_KINDS:
        tile = PREFIX_RUN_THREADS * PREFIX_RUN
        cols = -(-NB // tile) * (PREFIX_RUN_THREADS + 1)
    else:
        cols = -(-NB // PREFIX_TILE)
    out = torch.empty_like(totals)
    tiles = totals.new_empty((C, d * cols))
    _launch(f"block_prefix_{elem}", totals, out, tiles, d, NB, cols,
            int(bool(reverse)))
    return out


def smooth_totals(stack, moments):
    """K3a wrapper; see smooth_totals_plain."""
    if not _on_cuda(stack, moments):
        return smooth_totals_plain(stack, moments)
    L, lanes = _check_stack(stack, moments=moments, rows_min=9)
    totals = torch.empty((_N_SM, lanes), dtype=stack.dtype,
                         device=stack.device)
    _launch("ctcrw_smooth_totals", stack, moments, totals, stack.shape[1],
            L, lanes)
    return totals


def score_scan(stack, moments, suffix, h, p0_pos):
    """K3b wrapper; see score_scan_plain."""
    if not _on_cuda(stack, moments, suffix, h):
        return score_scan_plain(stack, moments, suffix, h, p0_pos)
    L, lanes = _check_stack(stack, moments=moments, rows_min=9)
    if tuple(suffix.shape) != (_N_SM, lanes):
        raise ValueError(f"suffix shape {tuple(suffix.shape)}")
    cot = torch.empty((L, _N_COT, lanes), dtype=stack.dtype,
                      device=stack.device)
    hbar = torch.empty((lanes,), dtype=stack.dtype, device=stack.device)
    _launch("ctcrw_score_scan", stack, moments, suffix, h, float(p0_pos),
            cot, hbar, stack.shape[1], L, lanes)
    return cot, hbar


def elem_filter_totals(stack, h, p0_pos, p0_vel):
    """K4a wrapper; see elem_filter_totals_plain."""
    if not _on_cuda(stack, h):
        return elem_filter_totals_plain(stack, h, p0_pos, p0_vel)
    L, lanes = _check_rows(stack, len(_ELEM_FWD_PAD))
    totals = stack.new_empty((_N_TOT, lanes))
    _launch("elem_filter_totals", stack, h, float(p0_pos), float(p0_vel),
            totals, L, lanes)
    return totals


def elem_filter_scan(stack, prefix, h, p0_pos, p0_vel):
    """K4b wrapper; see elem_filter_scan_plain."""
    if not _on_cuda(stack, prefix, h):
        return elem_filter_scan_plain(stack, prefix, h, p0_pos, p0_vel)
    L, lanes = _check_rows(stack, len(_ELEM_FWD_PAD))
    if tuple(prefix.shape) != (_N_TOT, lanes):
        raise ValueError(f"prefix shape {tuple(prefix.shape)}")
    moments = stack.new_empty((L, _N_MOM, lanes))
    llk = stack.new_empty((lanes,))
    _launch("elem_filter_scan", stack, prefix, h, float(p0_pos),
            float(p0_vel), moments, llk, L, lanes)
    return moments, llk


def elem_smooth_totals(stack, moments):
    """K5a wrapper; see elem_smooth_totals_plain."""
    if not _on_cuda(stack, moments):
        return elem_smooth_totals_plain(stack, moments)
    L, lanes = _check_rows(stack, len(_ELEM_BWD_PAD), moments)
    totals = stack.new_empty((_N_SM, lanes))
    _launch("elem_smooth_totals", stack, moments, totals, L, lanes)
    return totals


def elem_score_scan(stack, moments, suffix, h, p0_pos):
    """K5b wrapper; see elem_score_scan_plain."""
    if not _on_cuda(stack, moments, suffix, h):
        return elem_score_scan_plain(stack, moments, suffix, h, p0_pos)
    L, lanes = _check_rows(stack, len(_ELEM_BWD_PAD), moments)
    if tuple(suffix.shape) != (_N_SM, lanes):
        raise ValueError(f"suffix shape {tuple(suffix.shape)}")
    cot = stack.new_empty((L, _N_ECOT, lanes))
    hbar = stack.new_empty((lanes,))
    _launch("elem_score_scan", stack, moments, suffix, h, float(p0_pos), cot,
            hbar, L, lanes)
    return cot, hbar


class KernelOps(NamedTuple):
    filter_totals: Callable
    block_prefix: Callable
    filter_scan: Callable
    smooth_totals: Callable
    score_scan: Callable


OPS = {
    "kernels": KernelOps(filter_totals, block_prefix, filter_scan,
                         smooth_totals, score_scan),
    "plain": KernelOps(filter_totals_plain, block_prefix_plain,
                       filter_scan_plain, smooth_totals_plain,
                       score_scan_plain),
}
# the element-space path (K4a, K2, K4b forward; K5a, K2, K5b backward)
ELEM_OPS = {
    "kernels": KernelOps(elem_filter_totals, block_prefix, elem_filter_scan,
                         elem_smooth_totals, elem_score_scan),
    "plain": KernelOps(elem_filter_totals_plain, block_prefix_plain,
                       elem_filter_scan_plain, elem_smooth_totals_plain,
                       elem_score_scan_plain),
}


# ---------------------------------------------------------------------------
# Stitching time chunks (the `stitch` hooks; the time-sharded cores of
# ops/kalman_soa.py and ops/diag_fused.py). Between K2 and the rescan:
# the chunks' total elements per response dim, their exclusive prefix
# (suffix) over the chunks, and that seed composed into every block's
# prefix (suffix). The chunks are batched: one combine for all the
# totals, log2(chunks) for the seeds, one per device for the fold.
# ---------------------------------------------------------------------------

# packed rows of the filtering element's 2x2 blocks (A; C and J
# symmetric: their off-diagonal row twice)
_A_ROWS, _C_ROWS, _J_ROWS = [0, 1, 2, 3], [6, 7, 7, 8], [11, 12, 12, 13]


def _to_mat(v):
    """Packed filtering elements (14, ...) -> `_combine2_mat`'s (A, b, C,
    eta, J), event axes last."""
    def mat(rows):
        return v[rows].movedim(0, -1).reshape(v.shape[1:] + (2, 2))

    return (mat(_A_ROWS), v[4:6].movedim(0, -1), mat(_C_ROWS),
            v[9:11].movedim(0, -1), mat(_J_ROWS))


def _from_mat(e):
    A, b, C, eta, J = e
    lead = A.shape[:-2]
    tri = [0, 1, 3]  # (0, 0), (0, 1), (1, 1) of a flattened 2x2
    return torch.cat([A.reshape(lead + (4,)), b,
                      C.reshape(lead + (4,))[..., tri], eta,
                      J.reshape(lead + (4,))[..., tri]], dim=-1).movedim(
        -1, 0)


def _combine_packed(elem, a, b):
    """combine(a, b) of the kind `elem` on packed (C, ...) tensors; the
    filtering kind through `_combine2_mat`, its values bit for bit in
    ~60 tensor operations instead of ~150."""
    if elem == "filter":
        from smoothsde_tpu_torch.ops.kalman_soa import _combine2_mat

        return _from_mat(_combine2_mat(_to_mat(a), _to_mat(b)))
    k = ELEMS[elem]
    return torch.stack(k.pack(k.combine(k.unpack(a.unbind(0)),
                                        k.unpack(b.unbind(0)))))


def chunk_totals(excls, totals, d, elem, reverse, device):
    """(C, S, d) on `device`: the total element of all the steps of each
    of S chunks per response dim, from K2's exclusive prefixes and the
    block totals [(C, lanes_r)]: the prefix at each dim's last block
    composed with that block's total (reverse: the suffix at its first
    block with its total, which `_combine2_rev(acc, new)` puts outside).
    Padding slots hold identity elements, so the last block's padding
    adds nothing."""
    def pick(xs):
        return torch.stack([
            x.reshape(x.shape[0], d, -1)[..., 0 if reverse else -1].to(device)
            for x in xs], dim=1)

    return _combine_packed(elem, pick(excls), pick(totals))


def chunk_total(excl, totals, d, elem, reverse=False):
    """(C, d): `chunk_totals` of one chunk."""
    return chunk_totals([excl], [totals], d, elem, reverse, excl.device)[:, 0]


def stitch_seeds(totals, elem, reverse=False):
    """(C, S, d): the exclusive prefix over the S chunks (suffix if
    reverse) of their totals (C, S, d): chunk r's seed composes the totals
    of the chunks before it (after it), the identity at the first (last).
    Hillis-Steele over the chunks, as `block_prefix_plain` over blocks."""
    C, S, d = totals.shape
    ident = _const(ELEMS[elem].id_vals, totals)[:, None, None]
    x = totals.flip(1) if reverse else totals
    k = 1
    while k < S:
        x = _combine_packed(elem, torch.cat(
            [ident.expand(C, k, d), x[:, :-k]], dim=1), x)
        k *= 2
    x = torch.cat([ident.expand(C, 1, d), x[:, :-1]], dim=1)
    return x.flip(1) if reverse else x


def stitch_seeds_across(totals, elem, reverse, procs):
    """`stitch_seeds` of this process's chunks: with procs (a
    parallel/collectives.Processes) every process's chunk totals (C, S,
    d) are gathered in process order, the seeds formed over all of them,
    and this process's (C, S, d) kept; without, `stitch_seeds`."""
    if procs is None:
        return stitch_seeds(totals, elem, reverse)
    from smoothsde_tpu_torch.parallel.collectives import gather_plain

    S = totals.shape[1]
    seeds = stitch_seeds(gather_plain(totals, 1, procs), elem, reverse)
    return seeds[:, procs.rank * S:(procs.rank + 1) * S]


def seed_chunks(seeds, excls, d, elem):
    """[combine(seed_r, excl_r)]: each chunk's exclusive block prefixes
    (suffixes) (C, lanes_r) with its seed, seeds[:, r] (C, d), composed in
    before every block; for the reverse kinds the seed is the suffix of
    the later chunks, the accumulator `_combine2_rev` takes first. The
    chunks on one device in one combine; each result contiguous on its
    chunk's device."""
    out = [None] * len(excls)
    groups = {}
    for r, x in enumerate(excls):
        groups.setdefault(x.device, []).append(r)
    for dev, rs in groups.items():
        C = excls[rs[0]].shape[0]
        lanes = [excls[r].shape[1] for r in rs]
        s = torch.cat([seeds[:, r].to(dev)[:, :, None].expand(
            C, d, m // d).reshape(C, m) for r, m in zip(rs, lanes)], dim=1)
        x = torch.cat([excls[r] for r in rs], dim=1) if len(rs) > 1 \
            else excls[rs[0]]
        for r, y in zip(rs, _combine_packed(elem, s, x).split(lanes, dim=1)):
            out[r] = y.contiguous()
    return out


def seed_blocks(seed, excl, d, elem):
    """`seed_chunks` of one chunk: excl (C, lanes) with the seed (C, d)
    composed in before every block."""
    return seed_chunks(seed[:, None], [excl], d, elem)[0]


# ---------------------------------------------------------------------------
# Forward filter and backward score over the shared stack
# ---------------------------------------------------------------------------


def fused_filter_par(stack, bd, h, p: Plan, p0_pos, p0_vel,
                     ops: KernelOps = OPS["kernels"], stitch=None):
    """Forward filter: (llk, filtered moments (L, 5, lanes)). h is a
    1-element tensor on the stack's device. `stitch(chunk_total) -> seed`
    ((14, d) each, the JAX package's hook, ctcrw_fused.py:767-784) makes
    the stack one time chunk of a longer sequence: it receives the
    chunk's total filtering element and returns the exclusive prefix of
    the chunks before it, which seeds every block before K1b."""
    totals = ops.filter_totals(stack, bd, h, p0_pos, p0_vel)
    prefix = ops.block_prefix(totals, p.d, "filter", False)
    if stitch is not None:
        seed = stitch(chunk_total(prefix, totals, p.d, "filter"))
        prefix = seed_blocks(seed, prefix, p.d, "filter")
    moments, llk_lanes = ops.filter_scan(stack, bd, prefix, h, p0_pos,
                                         p0_vel)
    return llk_lanes.sum(), moments


def par_cotangents(cot, hbar_lanes, gbar, p: Plan):
    """K3b's (L, 4, lanes) cotangents and h partials scaled by gbar:
    (mubar (d, n), ltbar (n,), lnbar (n,), ybar (d, n), hbar 0-d)."""
    c_mu, c_lt, c_ln, c_y = unstack(cot, p)
    return (
        gbar * c_mu,
        gbar * c_lt.sum(0),
        gbar * c_ln.sum(0),
        gbar * c_y,
        gbar * hbar_lanes.sum(),
    )


def fused_backward_par(stack, moments, h, gbar, p: Plan, p0_pos,
                       ops: KernelOps = OPS["kernels"], stitch=None):
    """Backward: the Fisher-identity score scaled by gbar, as
    (mubar (d, n), ltbar (n,), lnbar (n,), ybar (d, n), hbar 0-d).
    `stitch(chunk_total) -> seed` ((9, d) each; JAX ctcrw_fused.py:
    1562-1584): the chunk's total smoothing element in, the exclusive
    suffix of the chunks after it out, seeding every block before K3b."""
    totals = ops.smooth_totals(stack, moments)
    suffix = ops.block_prefix(totals, p.d, "smooth", True)
    if stitch is not None:
        seed = stitch(chunk_total(suffix, totals, p.d, "smooth", True))
        suffix = seed_blocks(seed, suffix, p.d, "smooth")
    cot, hbar_lanes = ops.score_scan(stack, moments, suffix, h, p0_pos)
    return par_cotangents(cot, hbar_lanes, gbar, p)


# ---------------------------------------------------------------------------
# Element-space forward filter and backward score over a CtcrwSystem
# ---------------------------------------------------------------------------


def elem_forward_stack(sys, p: Plan):
    """(L, 10, lanes) element-space forward stack of a CtcrwSystem: the
    ENTERING transition's F[0][1], F[1][1], Q and c (F[0][0] = 1 and
    F[1][0] = 0 by construction), y and the reset / update masks."""
    dt = sys.yd.dtype
    Ft, ct, Qt = sys.Ft, sys.ct, sys.Qt
    return stack_rows([
        Ft[0][1], Ft[1][1], Qt[0][0], Qt[0][1], Qt[1][1], ct[0], ct[1],
        sys.yd, sys.reset.to(dt), sys.update.to(dt),
    ], _ELEM_FWD_PAD, p)


def elem_backward_stack(sys, p: Plan):
    """(L, 12, lanes) element-space backward stack of a CtcrwSystem, as
    the JAX package's `fused_backward` builds it: the transition LEAVING
    each slot (shifted back: 0 at the end, 1 for f11), the track end te
    (1 at the end), tvn (the leaving transition has a density), y and the
    update / reset masks."""
    dt = sys.yd.dtype
    Ft, ct, Qt = sys.Ft, sys.ct, sys.Qt
    rf = sys.reset.to(dt)
    tv = (~sys.reset & ~sys.prev_reset).to(dt)
    return stack_rows([
        _shift_back(Ft[0][1]), _shift_back(Ft[1][1], 1.0),
        _shift_back(Qt[0][0]), _shift_back(Qt[0][1]), _shift_back(Qt[1][1]),
        _shift_back(ct[0]), _shift_back(ct[1]),
        _shift_back(rf, 1.0), _shift_back(tv), sys.yd, sys.update.to(dt), rf,
    ], _ELEM_BWD_PAD, p)


def fused_filter(sys, ops: KernelOps = ELEM_OPS["kernels"], stitch=None):
    """Element-space fused forward filter of a CtcrwSystem (the JAX
    package's `fused_filter` with tiled moments): (llk, filtered moments
    (L, 5, lanes) in the stack layout of plan(d, n), rows m0, m1, P00,
    P01, P11). `stitch`: as in `fused_filter_par` (JAX ctcrw_fused.py:
    309, :451-476)."""
    d, n = sys.yd.shape
    stack = elem_forward_stack(sys, plan(d, n))
    h1 = sys.h.reshape(1).contiguous()
    totals = ops.filter_totals(stack, h1, sys.p0_pos, sys.p0_vel)
    prefix = ops.block_prefix(totals, d, "filter", False)
    if stitch is not None:
        seed = stitch(chunk_total(prefix, totals, d, "filter"))
        prefix = seed_blocks(seed, prefix, d, "filter")
    moments, llk_lanes = ops.filter_scan(stack, prefix, h1, sys.p0_pos,
                                         sys.p0_vel)
    return llk_lanes.sum(), moments


def fused_backward(sys, moments, gbar, ops: KernelOps = ELEM_OPS["kernels"]):
    """Element-space fused smoother + score: cotangents (Ftbar, ctbar,
    Qtbar, ybar, hbar) of a CtcrwSystem's (Ft, ct, Qt, yd, h), given the
    filtered moments of fused_filter, scaled by gbar. Every leaf is
    (d, n) in ENTERING indexing (the caller sums over the dims of a
    shared primal); Ft[0][0] and Ft[1][0] get zeros, and Qt[0][1],
    Qt[1][0] the same symmetric score, as in the JAX package.

    The backward stack holds the transition LEAVING each slot, so the
    kernel's score at slot i belongs to the transition entering i+1 and
    is shifted forward here. Padding makes identity smoothing elements:
    Fn = I and Qn = 0 with the real filter states the forward leaves in
    the padded moment slots give G = I, g = 0, L = 0."""
    d, n = sys.yd.shape
    p = plan(d, n)
    stack = elem_backward_stack(sys, p)
    h1 = sys.h.reshape(1).contiguous()
    totals = ops.smooth_totals(stack, moments)
    suffix = ops.block_prefix(totals, d, "smooth", True)
    cot, hbar_lanes = ops.score_scan(stack, moments, suffix, h1, sys.p0_pos)
    c = unstack(cot, p)
    f01, f11, q00, q01, q11, c0, c1 = (gbar * _shift(x) for x in c[:7])
    zero = torch.zeros_like(sys.yd)
    return (
        ((zero, f01), (zero, f11)),
        (c0, c1),
        ((q00, q01), (q01, q11)),
        gbar * c[7],
        gbar * hbar_lanes.sum(),
    )
