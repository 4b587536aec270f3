"""Structure-of-arrays (SoA) CTCRW Kalman filter on tensors.

Port of smoothsde_tpu/ops/kalman_soa.py for the CTCRW slice:

  - the 2x2 tuple algebra and the filtering element `Element2` with its
    associative combine `_combine2` (every matrix component is its own
    tensor over the step/lane axis, so a combine is elementwise);
  - `precompute_dt`, the host-side f64 inter-observation intervals;
  - the element-space system: `CtcrwSystem` / `_ctcrw_system` (the
    transition ENTERING each step and the filtering elements),
    `_build_elem2`, `_llk_from_filtered`, and the scan dispatch
    `_scan_elements` ("blocked" and "pallas" go through
    ops/scan_utils.py's `blocked_associative_scan`);
  - `ctcrw_loglik_soa`, the CTCRW log-likelihood with the JAX package's
    `scan` / `analytic_grad` dispatch. The fit's route (scan="fused",
    analytic_grad=True) takes its value from the fused par-space forward
    kernels and its gradient from the fused Fisher-identity backward
    kernels (ops/ctcrw_fused.py), wrapped as `CtcrwFusedCore`, a
    torch.autograd.Function at the same (par_mat, yd, h, dtv, resetf,
    validf) boundary as the JAX package's `_fused_par_core`; the other
    analytic routes go through `llk2_analytic` (ops/kalman_smooth.py);
  - `ctcrw_loglik_sequential`, a plain step-by-step filter
    differentiated by autograd, an independent oracle for the tests;
  - the scalar-state filtering combine `_comb1` (BM_SSM / OU_SSM, whose
    fused path lives in ops/diag_fused.py) and its step-by-step oracle
    `diag_ssm_loglik_sequential`.

Model conventions (state = (position, velocity) per response dim,
observation y = position + N(0, h), prior N((y_s, 0), diag(p0_pos,
p0_vel)) at each track start, identity transition out of a reset)
follow the reference's nllk_ctcrw.hpp:195-247.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


# ---- 2x2 tuple algebra (components are tensors, elementwise ops) ----


def _m2(X, Y):
    return (
        (
            X[0][0] * Y[0][0] + X[0][1] * Y[1][0],
            X[0][0] * Y[0][1] + X[0][1] * Y[1][1],
        ),
        (
            X[1][0] * Y[0][0] + X[1][1] * Y[1][0],
            X[1][0] * Y[0][1] + X[1][1] * Y[1][1],
        ),
    )


def _mv(X, v):
    return (
        X[0][0] * v[0] + X[0][1] * v[1],
        X[1][0] * v[0] + X[1][1] * v[1],
    )


def _t2(X):
    return ((X[0][0], X[1][0]), (X[0][1], X[1][1]))


def _madd(X, Y):
    return (
        (X[0][0] + Y[0][0], X[0][1] + Y[0][1]),
        (X[1][0] + Y[1][0], X[1][1] + Y[1][1]),
    )


def _vadd(u, v):
    return (u[0] + v[0], u[1] + v[1])


def _vsub(u, v):
    return (u[0] - v[0], u[1] - v[1])


def _inv2(X):
    det = X[0][0] * X[1][1] - X[0][1] * X[1][0]
    return (
        (X[1][1] / det, -X[0][1] / det),
        (-X[1][0] / det, X[0][0] / det),
    )


def _symm(X):
    off = 0.5 * (X[0][1] + X[1][0])
    return ((X[0][0], off), (off, X[1][1]))


class Element2(NamedTuple):
    """SoA filtering element for state dim 2."""

    A: tuple
    b: tuple
    C: tuple
    eta: tuple
    J: tuple


def _combine2(e1: Element2, e2: Element2) -> Element2:
    """Associative filtering combine: e1 covers the earlier steps."""
    CJ = _m2(e1.C, e2.J)
    G = ((1.0 + CJ[0][0], CJ[0][1]), (CJ[1][0], 1.0 + CJ[1][1]))
    M = _inv2(G)
    A2M = _m2(e2.A, M)
    A = _m2(A2M, e1.A)
    b = _vadd(_mv(A2M, _vadd(e1.b, _mv(e1.C, e2.eta))), e2.b)
    C = _symm(_madd(_m2(_m2(A2M, e1.C), _t2(e2.A)), e2.C))
    Nt = _t2(M)
    A1tN = _m2(_t2(e1.A), Nt)
    eta = _vadd(_mv(A1tN, _vsub(e2.eta, _mv(e2.J, e1.b))), e1.eta)
    J = _symm(_madd(_m2(_m2(A1tN, e2.J), e1.A), e1.J))
    return Element2(A, b, C, eta, J)


_ID2 = Element2(
    A=((1.0, 0.0), (0.0, 1.0)),
    b=(0.0, 0.0),
    C=((0.0, 0.0), (0.0, 0.0)),
    eta=(0.0, 0.0),
    J=((0.0, 0.0), (0.0, 0.0)),
)


def _comb1(e1, e2):
    """Scalar-state (A, b, C, eta, J) filtering combine, e1 the earlier
    steps (smoothsde_tpu/ops/diag_fused.py `_comb1`)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    M = 1.0 / (1.0 + C1 * J2)
    A2M = A2 * M
    return (
        A2M * A1,
        A2M * (b1 + C1 * eta2) + b2,
        A2M * C1 * A2 + C2,
        A1 * M * (eta2 - J2 * b1) + eta1,
        A1 * M * J2 * A1 + J1,
    )


_ID1 = (1.0, 0.0, 0.0, 0.0, 0.0)


def _wh(cond, X, Y):
    """torch.where over matching nested tuples (broadcasting)."""
    if isinstance(X, tuple):
        return tuple(_wh(cond, x, y) for x, y in zip(X, Y))
    return torch.where(cond, X, Y)


def _shift(x, fill=0.0):
    """x[..., i-1] at slot i, `fill` at 0."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def _shift_back(x, fill=0.0):
    """x[..., i+1] at slot i, `fill` at the end."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., 1:], pad], dim=-1)


def _scan_elements(combine, identity, elem, scan: str, reverse=False):
    """Inclusive scan of `elem` (leaves (..., n)) along the last axis.

    scan: "blocked" (the block decomposition of ops/scan_utils.py with
    its plain phases: no kernel, as the JAX package's "blocked"),
    "pallas" (the same with the phase-1 kernel K8 and K2 for CUDA
    tensors, forward-only), "auto" ("pallas" for CUDA tensors that need
    no gradient, "blocked" otherwise: the fast blocked scan of the
    device, as in the JAX package),
    "sequential" (one combine per step, a Python loop) or "associative"
    (Hillis-Steele over all n steps, plain torch). "fused" scans as
    "associative", as the JAX package's fallthrough does. reverse=True
    scans from the last step to the first (the smoother's order, the
    JAX package's flip / scan / flip). `combine` must be one of the
    element combines ops/ctcrw_fused.py's ELEMS knows."""
    from smoothsde_tpu_torch.ops import scan_utils

    if scan == "auto":
        leaves = [x for x in scan_utils.elem_kind(combine).pack(elem)
                  if isinstance(x, torch.Tensor)]
        grad = torch.is_grad_enabled() and any(x.requires_grad
                                               for x in leaves)
        scan = "pallas" if leaves[0].is_cuda and not grad else "blocked"
    if scan in ("blocked", "pallas"):
        return scan_utils.blocked_associative_scan(
            combine, identity, elem,
            phase1="plain" if scan == "blocked" else "pallas",
            reverse=reverse,
        )
    if scan not in ("sequential", "associative", "fused"):
        raise ValueError(f"unknown scan {scan!r}")
    if scan != "sequential" and combine is _combine2 and not reverse:
        return _associative_elem2(elem)
    kind = scan_utils.elem_kind(combine)
    leaves = kind.pack(elem)
    shape = torch.broadcast_shapes(*(x.shape for x in leaves))
    xs = [x.expand(shape) for x in leaves]
    if reverse:
        xs = [x.flip(-1) for x in xs]
    ids = kind.pack(identity)
    if scan == "sequential":
        carry = kind.unpack([x.new_full(shape[:-1], v) for x, v in
                             zip(xs, ids)])
        outs = []
        for i in range(shape[-1]):
            carry = combine(carry, kind.unpack([x[..., i] for x in xs]))
            outs.append(kind.pack(carry))
        xs = [torch.stack(c, dim=-1) for c in zip(*outs)]
    else:  # Hillis-Steele: x_i <- x_{i-k} (+) x_i, k = 1, 2, 4, ...
        k = 1
        while k < shape[-1]:
            sh = [torch.cat([x.new_full(shape[:-1] + (k,), v), x[..., :-k]],
                            dim=-1) for x, v in zip(xs, ids)]
            xs = kind.pack(combine(kind.unpack(sh), kind.unpack(xs)))
            k *= 2
    if reverse:
        xs = [x.flip(-1) for x in xs]
    return kind.unpack(xs)


def _combine2_mat(e1, e2):
    """`_combine2` on (A, b, C, eta, J) with 2x2 matrix and 2-vector
    event axes last: the same operations in the same order (its values
    bit for bit) in ~45 tensor operations instead of ~150."""
    from smoothsde_tpu_torch.ops.kalman import _mm, _sym
    from smoothsde_tpu_torch.ops.kalman import _mv as _mvm

    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    G = _mm(C1, J2) + torch.eye(2, dtype=C1.dtype, device=C1.device)
    g00, g01, g10, g11 = G[..., 0, 0], G[..., 0, 1], G[..., 1, 0], G[..., 1, 1]
    det = g00 * g11 - g01 * g10
    M = torch.stack([torch.stack([g11 / det, -g01 / det], -1),
                     torch.stack([-g10 / det, g00 / det], -1)], -2)
    A2M = _mm(A2, M)
    A1tN = _mm(A1.transpose(-1, -2), M.transpose(-1, -2))
    return (_mm(A2M, A1), _mvm(A2M, b1 + _mvm(C1, eta2)) + b2,
            _sym(_mm(_mm(A2M, C1), A2.transpose(-1, -2)) + C2),
            _mvm(A1tN, eta2 - _mvm(J2, b1)) + eta1,
            _sym(_mm(_mm(A1tN, J2), A1) + J1))


def _associative_elem2(elem: Element2) -> Element2:
    """Hillis-Steele scan of filtering elements (leaves (..., n)) with
    `_combine2_mat`: five tensors a level instead of fourteen."""
    (a00, a01, a10, a11, b0, b1, c00, c01, c10, c11, e0, e1, j00, j01, j10,
     j11) = torch.broadcast_tensors(
        *elem.A[0], *elem.A[1], *elem.b, *elem.C[0], *elem.C[1], *elem.eta,
        *elem.J[0], *elem.J[1])

    def mat(x00, x01, x10, x11):
        return torch.stack([torch.stack([x00, x01], -1),
                            torch.stack([x10, x11], -1)], -2)

    xs = [mat(a00, a01, a10, a11), torch.stack([b0, b1], -1),
          mat(c00, c01, c10, c11), torch.stack([e0, e1], -1),
          mat(j00, j01, j10, j11)]
    n, k = a00.shape[-1], 1
    eye = torch.eye(2, dtype=a00.dtype, device=a00.device)
    while k < n:
        sh = []
        for i, x in enumerate(xs):
            ax = a00.dim() - 1  # the step axis; event axes follow it
            fill = x.new_zeros(x.shape[:ax] + (k,) + x.shape[ax + 1:])
            if i == 0:  # the identity element's A
                fill = fill + eye
            sh.append(torch.cat([fill, x.narrow(ax, 0, n - k)], dim=ax))
        xs = list(_combine2_mat(tuple(sh), tuple(xs)))
        k *= 2
    A, b, C, eta, J = xs

    def tup(X):
        return ((X[..., 0, 0], X[..., 0, 1]), (X[..., 1, 0], X[..., 1, 1]))

    return Element2(tup(A), (b[..., 0], b[..., 1]), tup(C),
                    (eta[..., 0], eta[..., 1]), tup(J))


def precompute_dt(times, ids):
    """Host-side f64 inter-observation intervals with cross-track
    sanitization (dt = 1 across ID breaks and at the dummy last slot).

    Absolute times encoded in f32 quantize the diffs, so the intervals
    are computed in f64 BEFORE any device cast."""
    t = np.asarray(times, np.float64)
    i = np.asarray(ids)
    same = i[1:] == i[:-1]
    dt = np.where(same, np.diff(t), 1.0)
    return np.concatenate([dt, np.ones(1)])


class CtcrwData(NamedTuple):
    """Per-step data at the likelihood boundary, on the working device
    and in the working dtype: yd (d, n) observations with NaN -> 0,
    dtv (n,) intervals, resetf/validf (n,) 0/1 masks (track start;
    finite first response column)."""

    yd: torch.Tensor
    dtv: torch.Tensor
    resetf: torch.Tensor
    validf: torch.Tensor


def prepare_ctcrw_data(obs, times, ids, *, dtype, device):
    """Build CtcrwData host-side (NumPy, f64) and move it once."""
    obs = np.asarray(obs, np.float64)
    ids = np.asarray(ids)
    dt = precompute_dt(times, ids)
    reset = np.concatenate([[True], ids[1:] != ids[:-1]])
    valid = np.isfinite(obs[:, 0])

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float64)).to(
            device=device, dtype=dtype
        )

    return CtcrwData(
        yd=dev(np.nan_to_num(obs, nan=0.0).T),
        dtv=dev(dt),
        resetf=dev(reset),
        validf=dev(valid),
    )


class CtcrwSystem(NamedTuple):
    """Per-step SoA system pieces for the s=2 filter (all leaves end in
    the step axis): the transition ENTERING each step, Ft and Qt (n,)
    (shared by the response dims), ct (d, n); observations yd (d, n); h
    0-d; bool masks (n,) reset, prev_reset, update; the filtering
    elements (leaves (d, n)); the prior variances at track starts."""

    Ft: tuple
    ct: tuple
    Qt: tuple
    yd: torch.Tensor
    h: torch.Tensor
    reset: torch.Tensor
    prev_reset: torch.Tensor
    update: torch.Tensor
    elem: Element2
    p0_pos: float
    p0_vel: float


def _ctcrw_system(par_mat, obs, times, ids, sigma_obs, p0_pos=1.0,
                  p0_vel=10.0, dt=None, yd=None, h=None, reset=None,
                  valid=None) -> CtcrwSystem:
    """The per-step SoA system and filtering elements from par_mat
    (n, d+2) on the working scale (shared by the likelihood, the smoother
    and the analytic-gradient core), as the JAX package's `_ctcrw_system`.

    dt defaults to the host f64 intervals (precompute_dt). `yd` (d, n),
    `h` (0-d), `reset` and `valid` (bool (n,)) override what would be
    derived from obs / sigma_obs / ids; with all of dt, yd, reset and
    valid given, obs/times/ids may be None. (The JAX package's
    `pre_shifted` / `prev_reset`, which only time sharding needs, are not
    ported.)"""
    dtype, device = par_mat.dtype, par_mat.device

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=device, dtype=dtype
        )

    if dt is None:
        dt = dev(precompute_dt(times, ids))
    if reset is None:
        i = np.asarray(ids)
        reset = torch.as_tensor(np.concatenate([[True], i[1:] != i[:-1]]),
                                device=device)
    if valid is None:
        valid = torch.as_tensor(
            np.isfinite(np.asarray(obs, np.float64)[:, 0]), device=device
        )
    if yd is None:
        yd = dev(np.nan_to_num(np.asarray(obs, np.float64), nan=0.0).T)
    if h is None:
        h = torch.as_tensor(sigma_obs, dtype=dtype, device=device) ** 2
    d = yd.shape[0]

    from smoothsde_tpu_torch.ops.stable import ctcrw_transition_terms

    mu = par_mat[:, :d]
    tau = torch.exp(par_mat[:, d])
    nu = torch.exp(par_mat[:, d + 1])
    beta = 1.0 / tau
    sigma2 = 4.0 * nu * nu / (math.pi * tau)
    tt = ctcrw_transition_terms(beta, sigma2, dt)
    bp = tt["bp"][None, :] * mu.T  # (d, n) position drift
    bv = tt["bv"][None, :] * mu.T  # velocity drift

    # shift to "transition entering step i"; identity out of a reset
    prev_reset = torch.cat([reset.new_ones(1), reset[:-1]])
    q01 = torch.where(prev_reset, 0.0, _shift(tt["q01"]))
    Ft = (
        (torch.ones_like(dt), torch.where(prev_reset, 0.0, _shift(tt["g"]))),
        (torch.zeros_like(dt),
         torch.where(prev_reset, 1.0, _shift(tt["e1"], 1.0))),
    )
    Qt = (
        (torch.where(prev_reset, 0.0, _shift(tt["q00"])), q01),
        (q01, torch.where(prev_reset, 0.0, _shift(tt["q11"]))),
    )
    ct = (torch.where(prev_reset, 0.0, _shift(bp)),
          torch.where(prev_reset, 0.0, _shift(bv)))
    update = valid & ~reset
    return CtcrwSystem(
        Ft=Ft, ct=ct, Qt=Qt, yd=yd, h=h, reset=reset,
        prev_reset=prev_reset, update=update,
        elem=_build_elem2(Ft, ct, Qt, yd, h, reset, update, p0_pos, p0_vel),
        p0_pos=float(p0_pos), p0_vel=float(p0_vel),
    )


def _build_elem2(Ft, ct, Qt, yd, h, reset, update, p0_pos, p0_vel):
    """Filtering elements (leaves (d, n)) from the system pieces: the
    three-way select between reset, measurement update (Z = [1, 0],
    scalar S) and propagate-only."""
    S = Qt[0][0] + h
    K0 = Qt[0][0] / S
    K1 = Qt[1][0] / S
    r = yd - ct[0]
    A_upd = (
        ((1.0 - K0) * Ft[0][0], (1.0 - K0) * Ft[0][1]),
        (Ft[1][0] - K1 * Ft[0][0], Ft[1][1] - K1 * Ft[0][1]),
    )
    b_upd = (ct[0] + K0 * r, ct[1] + K1 * r)
    C_upd = (
        ((1.0 - K0) * Qt[0][0], (1.0 - K0) * Qt[0][1]),
        (Qt[1][0] - K1 * Qt[0][0], Qt[1][1] - K1 * Qt[0][1]),
    )
    f0, f1 = Ft[0][0], Ft[0][1]
    eta_upd = (f0 * r / S, f1 * r / S)
    J_upd = ((f0 * f0 / S, f0 * f1 / S), (f0 * f1 / S, f1 * f1 / S))

    zero = torch.zeros_like(yd)
    zz = ((zero, zero), (zero, zero))
    upd_only = update & ~reset
    return Element2(
        A=_wh(reset, zz, _wh(update, A_upd, Ft)),
        b=_wh(reset, (yd, zero), _wh(update, b_upd, ct)),
        C=_wh(
            reset,
            ((torch.full_like(yd, p0_pos), zero),
             (zero, torch.full_like(yd, p0_vel))),
            _wh(update, C_upd, Qt),
        ),
        eta=_wh(upd_only, eta_upd, (zero, zero)),
        J=_wh(upd_only, J_upd, zz),
    )


def _llk_from_filtered(sys: CtcrwSystem, m_f, P_f):
    """Predictive log-likelihood recovered elementwise from the filtered
    moments m_f (2-tuple), P_f (2x2 tuple), leaves (d, n)."""
    Ft, ct, Qt, yd, h = sys.Ft, sys.ct, sys.Qt, sys.yd, sys.h
    m0p, m1p = _shift(m_f[0]), _shift(m_f[1])
    P00p, P01p, P11p = _shift(P_f[0][0]), _shift(P_f[0][1]), _shift(P_f[1][1])
    a_pred0 = Ft[0][0] * m0p + Ft[0][1] * m1p + ct[0]
    Pp00 = (
        Ft[0][0] * (Ft[0][0] * P00p + Ft[0][1] * P01p)
        + Ft[0][1] * (Ft[0][0] * P01p + Ft[0][1] * P11p)
        + Qt[0][0]
    )
    a_pred0 = torch.where(sys.reset, yd, a_pred0)
    Pp00 = torch.where(sys.reset, sys.p0_pos, Pp00)
    F = Pp00 + h
    u = yd - a_pred0
    return torch.where(sys.update, -0.5 * (torch.log(F) + u * u / F),
                       0.0).sum()


def _make_core(ops_name: str):
    """autograd.Function over the fused forward/backward, built on the
    op table `ops_name` of ops/ctcrw_fused.py: "kernels" (the wrappers,
    which launch the CUDA kernels for CUDA tensors) or "plain" (the
    plain PyTorch versions, for comparing the two on the card)."""

    class _Core(torch.autograd.Function):
        @staticmethod
        def forward(ctx, par_mat, yd, h, dtv, resetf, validf, p0_pos,
                    p0_vel):
            from smoothsde_tpu_torch.ops import ctcrw_fused as cf

            ops = cf.OPS[ops_name]
            d, n = yd.shape
            plan = cf.plan(d, n)
            h1 = h.reshape(1).contiguous()
            stack, bd = cf.par_stack_from_data(
                par_mat, yd, dtv, resetf, validf, plan
            )
            llk, moments = cf.fused_filter_par(
                stack, bd, h1, plan, p0_pos, p0_vel, ops
            )
            ctx.save_for_backward(stack, moments, h1)
            ctx.plan = plan
            ctx.p0_pos = p0_pos
            ctx.h_shape = h.shape
            return llk

        @staticmethod
        def backward(ctx, gbar):
            from smoothsde_tpu_torch.ops import ctcrw_fused as cf

            stack, moments, h1 = ctx.saved_tensors
            plan = ctx.plan
            mubar, ltbar, lnbar, ybar, hbar = cf.fused_backward_par(
                stack, moments, h1, gbar, plan, ctx.p0_pos,
                cf.OPS[ops_name],
            )
            par_bar = torch.cat(
                [mubar.T, ltbar[:, None], lnbar[:, None]], dim=1
            )
            # dt and the masks are data, not parameters: no cotangents
            return (par_bar, ybar, hbar.reshape(ctx.h_shape), None, None,
                    None, None, None)

    _Core.__name__ = _Core.__qualname__ = (
        "CtcrwFusedCore" if ops_name == "kernels" else "CtcrwPlainCore"
    )
    return _Core


# Kernel-backed CTCRW log-likelihood: forward = fused filter, backward =
# fused smoother + Fisher-identity score. Arguments (par_mat (n, d+2),
# yd (d, n), h 0-d, dtv (n,), resetf (n,), validf (n,), p0_pos, p0_vel).
CtcrwFusedCore = _make_core("kernels")
# The same computation through the plain PyTorch versions only.
CtcrwPlainCore = _make_core("plain")


def ctcrw_loglik_soa(par_mat, obs, times, ids, sigma_obs, p0_pos=1.0,
                     p0_vel=10.0, scan: str = "auto",
                     analytic_grad: bool = False, data: CtcrwData = None):
    """Total CTCRW log-likelihood.

    par_mat: (n, d+2) working scale (mu_1..mu_d, log tau, log nu) on the
    working device; obs: (n, d) with NaN missing rows (first-response
    check, as in the reference); sigma_obs: scalar measurement SD (a
    tensor to differentiate through it). Pass `data` (prepare_ctcrw_data)
    to skip rebuilding the per-step data; obs/times/ids are then unused.

    Dispatch as in the JAX package:
      - scan="fused", analytic_grad=True: the fit's route, the fused
        par-space kernels with the Fisher-identity gradient
        (`CtcrwFusedCore`);
      - analytic_grad=True otherwise: `llk2_analytic(sys, scan)`, the
        element-space Fisher-identity autograd.Function;
      - scan="fused": the element-space fused forward (K4a, K2, K4b);
      - any other scan: `_scan_elements` + `_llk_from_filtered`.
    Differentiable in par_mat and sigma_obs (reverse mode). On a CUDA
    device the kernels are forward-only, so a gradient needs
    analytic_grad=True."""
    if analytic_grad and scan == "fused":
        if data is None:
            data = prepare_ctcrw_data(
                obs, times, ids, dtype=par_mat.dtype, device=par_mat.device
            )
        h = torch.as_tensor(
            sigma_obs, dtype=par_mat.dtype, device=par_mat.device
        ) ** 2
        return CtcrwFusedCore.apply(
            par_mat, data.yd, h, data.dtv, data.resetf, data.validf,
            float(p0_pos), float(p0_vel),
        )
    over = {}
    if data is not None:
        over = dict(dt=data.dtv, yd=data.yd, reset=data.resetf > 0.5,
                    valid=data.validf > 0.5)
    sys = _ctcrw_system(par_mat, obs, times, ids, sigma_obs, p0_pos, p0_vel,
                        **over)
    if analytic_grad:
        from smoothsde_tpu_torch.ops.kalman_smooth import llk2_analytic

        return llk2_analytic(sys, scan)
    if scan == "fused":
        from smoothsde_tpu_torch.ops.ctcrw_fused import fused_filter

        return fused_filter(sys)[0]
    scanned = _scan_elements(_combine2, _ID2, sys.elem, scan)
    return _llk_from_filtered(sys, scanned.b, scanned.C)


def ctcrw_loglik_sequential(par_mat, obs, times, ids, sigma_obs,
                            p0_pos=1.0, p0_vel=10.0):
    """Plain step-by-step CTCRW filter, differentiated by autograd.

    Builds the per-step filtering elements as the JAX package's
    `_ctcrw_system` does and composes them one step at a time (a Python
    loop over the n steps), then recovers the predictive likelihood
    from the filtered moments. O(n) Python steps: for tests at small n.
    """
    from smoothsde_tpu_torch.ops.stable import ctcrw_transition_terms

    dtype, device = par_mat.dtype, par_mat.device
    data = prepare_ctcrw_data(obs, times, ids, dtype=dtype, device=device)
    yd = data.yd  # (d, n)
    d, n = yd.shape
    reset = data.resetf > 0.5
    update = (data.validf > 0.5) & ~reset
    prev_reset = torch.cat([reset.new_ones(1), reset[:-1]])

    mu = par_mat[:, :d].T  # (d, n)
    tau = torch.exp(par_mat[:, d])
    nu = torch.exp(par_mat[:, d + 1])
    beta = 1.0 / tau
    sigma2 = 4.0 * nu * nu / (math.pi * tau)
    tt = ctcrw_transition_terms(beta, sigma2, data.dtv)
    h = torch.as_tensor(sigma_obs, dtype=dtype, device=device) ** 2

    zero = torch.zeros_like(yd)
    np_ = prev_reset  # identity transition out of a reset
    f01 = torch.where(np_, 0.0, _shift(tt["g"]))
    f11 = torch.where(np_, 1.0, _shift(tt["e1"], 1.0))
    q00 = torch.where(np_, 0.0, _shift(tt["q00"]))
    q01 = torch.where(np_, 0.0, _shift(tt["q01"]))
    q11 = torch.where(np_, 0.0, _shift(tt["q11"]))
    c0 = torch.where(np_, 0.0, _shift(tt["bp"][None, :] * mu))
    c1 = torch.where(np_, 0.0, _shift(tt["bv"][None, :] * mu))

    from smoothsde_tpu_torch.ops.ctcrw_fused import (
        _ID_VALS,
        _elem_from_vals,
        _pack_elem,
        _unpack_elem_full,
    )

    e = _elem_from_vals(
        f01 + zero, f11 + zero, q00 + zero, q01 + zero, q11 + zero,
        c0, c1, yd, data.resetf + zero, (update.to(dtype)) + zero,
        p0_pos, p0_vel, h,
    )
    flat = _pack_elem(e)
    carry = _unpack_elem_full(
        [torch.full((d,), v, dtype=dtype, device=device) for v in _ID_VALS]
    )
    m0s, m1s, P00s, P01s, P11s = [], [], [], [], []
    for i in range(n):
        carry = _combine2(carry, _unpack_elem_full([c[:, i] for c in flat]))
        m0s.append(carry.b[0])
        m1s.append(carry.b[1])
        P00s.append(carry.C[0][0])
        P01s.append(carry.C[0][1])
        P11s.append(carry.C[1][1])
    m0, m1, P00, P01, P11 = (
        torch.stack(x, dim=-1) for x in (m0s, m1s, P00s, P01s, P11s)
    )

    # predictive likelihood from the filtered moments at i - 1
    m0p, m1p = _shift(m0), _shift(m1)
    P00p, P01p, P11p = _shift(P00), _shift(P01), _shift(P11)
    a_pred0 = m0p + f01 * m1p + c0
    Pp00 = P00p + 2.0 * f01 * P01p + f01 * f01 * P11p + q00
    a_pred0 = torch.where(reset, yd, a_pred0)
    Pp00 = torch.where(reset, p0_pos, Pp00)
    F = Pp00 + h
    u = yd - a_pred0
    terms = torch.where(update, -0.5 * (torch.log(F) + u * u / F), 0.0)
    return terms.sum()


def diag_ssm_loglik_sequential(type, par_mat, obs, times, ids, sigma_obs,
                               p0=10.0):
    """Plain step-by-step BM_SSM / OU_SSM filter, differentiated by
    autograd: mirrors the JAX package's `diag_ssm_loglik_soa` with a
    Python loop over the n steps composing the scalar filtering elements
    with `_comb1`. For tests at small n."""
    from smoothsde_tpu_torch.ops import diag_fused as df

    sysd = df.diag_system(type, par_mat, obs, times, ids, sigma_obs, p0=p0)
    flat = df.diag_elements(sysd)
    d = sysd.yd.shape[0]
    carry = tuple(
        torch.full((d,), v, dtype=par_mat.dtype, device=par_mat.device)
        for v in _ID1
    )
    bs, Cs = [], []
    for i in range(sysd.yd.shape[1]):
        carry = _comb1(carry, tuple(x[:, i] for x in flat))
        bs.append(carry[1])
        Cs.append(carry[2])
    return df.diag_llk_from_filtered(
        sysd, torch.stack(bs, dim=-1), torch.stack(Cs, dim=-1)
    )


def diag_ssm_loglik_soa(type, par_mat, obs, times, ids, sigma_obs,
                        scan: str = "auto", data=None):
    """BM_SSM / OU_SSM log-likelihood through a scalar-state SoA filter:
    ops/diag_fused.py's per-step system and 5-comp filtering elements
    (`diag_system`, `diag_elements`), composed by `_comb1` through
    `_scan_elements` ("blocked", "associative", "sequential", or
    "pallas": K8 and K2 on a CUDA tensor, forward-only), the likelihood
    recovered elementwise (`diag_llk_from_filtered`). Off "pallas" it is
    plain tensor arithmetic: every order of torch.func runs through it.
    Port of the JAX package's `diag_ssm_loglik_soa`
    (ops/kalman_soa.py:835-938). Pass `data` (prepare_diag_data of the
    same type) to skip rebuilding the per-step data; obs/times/ids are
    then unused."""
    from smoothsde_tpu_torch.ops import diag_fused as df

    sysd = df.diag_system(type, par_mat, obs, times, ids, sigma_obs,
                          data=data)
    _, bf, Cf, _, _ = _scan_elements(_comb1, _ID1, df.diag_elements(sysd),
                                     scan)
    return df.diag_llk_from_filtered(sysd, bf, Cf)


# ---------------------------------------------------------------------------
# Time-sharded CTCRW core (JAX kalman_soa.py:673-832)
# ---------------------------------------------------------------------------


class CtcrwChunk(NamedTuple):
    """One time chunk, rows [start, stop) of a CtcrwData, on its shard's
    device: yd (d, m); dtv, te, tvn, upd, rst (m,), the masks that look
    one slot ahead (te, tvn) computed on the whole sequence; dt_prev and
    prst0 (0-d): the interval and the track-start mask of the slot before
    the chunk (1 and 1 at the sequence's start)."""

    yd: torch.Tensor
    dtv: torch.Tensor
    te: torch.Tensor
    tvn: torch.Tensor
    upd: torch.Tensor
    rst: torch.Tensor
    dt_prev: torch.Tensor
    prst0: torch.Tensor


def split_ctcrw_data(data: CtcrwData, sizes, devices, start: int = 0):
    """The CtcrwChunks of consecutive chunks of `sizes` steps from step
    `start` on, chunk r on devices[r]. The masks are those of
    par_stack_from_data, formed before the split so that they see across
    the chunks' edges."""
    resetf, one = data.resetf, data.resetf.new_ones(1)
    prevf = torch.cat([one, resetf[:-1]])
    tv = (1.0 - resetf) * (1.0 - prevf)
    rows = dict(
        te=torch.cat([resetf[1:], one]),
        tvn=torch.cat([tv[1:], resetf.new_zeros(1)]),
        upd=data.validf * (1.0 - resetf), rst=resetf, dtv=data.dtv,
    )
    dt_prev = torch.cat([one, data.dtv[:-1]])
    chunks, s = [], start
    for m, dev in zip(sizes, devices):
        part = {k: v[s:s + m].to(dev) for k, v in rows.items()}
        chunks.append(CtcrwChunk(yd=data.yd[:, s:s + m].to(dev),
                                 dt_prev=dt_prev[s].to(dev),
                                 prst0=prevf[s].to(dev), **part))
        s += m
    return chunks


class TimeShardedCtcrwCore(torch.autograd.Function):
    """CtcrwFusedCore over a sequence cut into time chunks, each on its
    own device, stitched exactly. apply(chunks, ops_name, p0_pos, p0_vel,
    h, procs, ent, *pars): `split_ctcrw_data`'s chunks, the op table of
    ops/ctcrw_fused.py ("kernels" or "plain"), h 0-d on the output's
    device, each chunk's (m, d+2) par rows on its device. procs: None,
    or the parallel/collectives.Processes of a ("dcn", axis) mesh whose
    process holds these chunks (the same number in each, process-major);
    ent: the par row entering the first chunk (None: its own first row,
    at the sequence's start). Returns the llk of the chunks, 0-d on h's
    device.

    Forward: each chunk's stack (its lane 0 entering from the previous
    chunk's last par row, `build_par_stack(ent=)`), K1a and K2; the
    chunks' totals gathered on h's device (and across the processes)
    give each chunk's exclusive prefix (the JAX `stitch_fwd`), copied
    back and composed into its blocks' prefixes before K1b
    (ops/ctcrw_fused.py `chunk_totals`, `stitch_seeds`, `seed_chunks`).
    Backward, mirrored: K3a, K2 reversed, the gathered totals' exclusive
    suffixes (`stitch_bwd`), the seeded K3b. No autograd crosses a
    device: the smoother is the adjoint of the filter, so each chunk's
    seeded K3b gives d(total llk)/d(its par) directly, the score of each
    slot's leaving transition at the slot itself; the entering row lane 0
    reads from the previous chunk gets no cotangent (JAX :815-830), so it
    is taken without a gradient. One output, the llk: K3b's score is the
    gradient of the sequence's total, so only the total's cotangent has a
    meaning (the JAX package returns per-device partials only because of
    shard_map's cotangent convention); across processes the objective
    sums the processes' outputs and their cotangents
    (parallel/collectives.py)."""

    @staticmethod
    def forward(ctx, chunks, ops_name, p0_pos, p0_vel, h, procs, ent,
                *pars):
        from smoothsde_tpu_torch.ops import ctcrw_fused as cf

        ops = cf.OPS[ops_name]
        d = chunks[0].yd.shape[0]
        state, totals, pres = [], [], []
        for r, (c, par) in enumerate(zip(chunks, pars)):
            p = cf.plan(d, par.shape[0])
            h1 = h.reshape(1).to(par.device)
            prev = pars[r - 1][-1] if r else (par[0] if ent is None
                                              else ent)
            prev = prev.to(par.device)
            stack, bd = cf.build_par_stack(
                par[:, :d].T, par[:, d], par[:, d + 1], c.dtv, c.te, c.tvn,
                c.yd, c.upd, c.rst, p,
                ent=(prev[d], prev[d + 1], c.dt_prev, prev[:d], c.prst0))
            totals.append(ops.filter_totals(stack, bd, h1, p0_pos, p0_vel))
            pres.append(ops.block_prefix(totals[-1], d, "filter", False))
            state.append((p, stack, bd, h1))
        seeds = cf.stitch_seeds_across(cf.chunk_totals(
            pres, totals, d, "filter", False, h.device), "filter", False,
            procs)
        llk, saved = [], []
        for (p, stack, bd, h1), pre in zip(
                state, cf.seed_chunks(seeds, pres, d, "filter")):
            mom, ll = ops.filter_scan(stack, bd, pre, h1, p0_pos, p0_vel)
            llk.append(ll.sum().to(h.device))
            saved += [stack, mom, h1]
        ctx.save_for_backward(*saved)
        ctx.plans = [s[0] for s in state]
        ctx.ops_name, ctx.p0_pos, ctx.h_shape = ops_name, p0_pos, h.shape
        ctx.procs = procs
        return torch.stack(llk).sum()

    @staticmethod
    def backward(ctx, gbar):
        from smoothsde_tpu_torch.ops import ctcrw_fused as cf

        ops = cf.OPS[ctx.ops_name]
        saved = ctx.saved_tensors
        triples = [saved[i:i + 3] for i in range(0, len(saved), 3)]
        d = ctx.plans[0].d
        totals, sufs = [], []
        for stack, mom, _ in triples:
            totals.append(ops.smooth_totals(stack, mom))
            sufs.append(ops.block_prefix(totals[-1], d, "smooth", True))
        seeds = cf.stitch_seeds_across(cf.chunk_totals(
            sufs, totals, d, "smooth", True, gbar.device), "smooth", True,
            ctx.procs)
        par_bars, hbars = [], []
        for (stack, mom, h1), p, suf in zip(
                triples, ctx.plans, cf.seed_chunks(seeds, sufs, d, "smooth")):
            cot, hb = ops.score_scan(stack, mom, suf, h1, ctx.p0_pos)
            mubar, ltbar, lnbar, _, hb = cf.par_cotangents(
                cot, hb, gbar.to(stack.device), p)
            par_bars.append(torch.cat([mubar.T, ltbar[:, None],
                                       lnbar[:, None]], dim=1))
            hbars.append(hb.to(gbar.device))
        return (None, None, None, None,
                torch.stack(hbars).sum().reshape(ctx.h_shape), None, None,
                *par_bars)


def fused_par_core_time_sharded(pars, chunks, h, ops_name="kernels",
                                p0_pos=1.0, p0_vel=10.0, *, procs=None,
                                ent=None):
    """The time-sharded CTCRW log-likelihood (JAX kalman_soa.py:673),
    differentiable in the chunks' par rows `pars` and in h: see
    TimeShardedCtcrwCore."""
    return TimeShardedCtcrwCore.apply(chunks, ops_name, float(p0_pos),
                                      float(p0_vel), h, procs, ent, *pars)
