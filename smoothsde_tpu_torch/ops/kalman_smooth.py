"""Parallel RTS smoother and analytic (Fisher-identity) gradients for
the s=2 SoA Kalman filter.

Port of smoothsde_tpu/ops/kalman_smooth.py, and of the scalar-state
smoothing algebra of smoothsde_tpu/ops/diag_fused.py (`_comb1_rev`,
`_ID1_SM`). The score of a linear-Gaussian state-space model has a
closed form (Fisher/EM identity),

    d llk / d theta = E[ d log p(x, y; theta) / d theta | y ],

elementwise in the smoothed means / covariances and lag-one
cross-covariances, which one reversed scan of RTS smoothing elements
gives (Särkkä & García-Fernández). `llk2_analytic` wraps the filter as a
torch.autograd.Function: forward = filter, backward = smoother +
elementwise score. With scan="fused" both run on the element-space
fused kernels (ops/ctcrw_fused.py: K4a/K4b, K5a/K5b); with the other
scans through `_scan_elements` (scan="pallas" / "auto" on a CUDA device:
the phase-1 kernel K8 of ops/scan_utils.py).

Also the user-facing smoothed state moments (`ctcrw_smoothed_states`),
which the reference does not have (it only REPORTs filtered states,
nllk_ctcrw.hpp:249).

Model conventions match ops/kalman_soa.py: the transition (Ft, ct, Qt)
ENTERING step i, identity out of a reset; y_i = x_i[0] + N(0, h) where
`update`; prior N((y_s, 0), diag(p0_pos, p0_vel)) at reset indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smoothsde_tpu_torch.ops.kalman_soa import (
    _ID2,
    _build_elem2,
    _combine2,
    _inv2,
    _llk_from_filtered,
    _m2,
    _madd,
    _mv,
    _scan_elements,
    _shift,
    _shift_back,
    _symm,
    _t2,
    _vadd,
    _vsub,
    _wh,
)


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


def _tmap(fn, X):
    """fn over the leaves of a nested tuple."""
    if isinstance(X, tuple):
        return tuple(_tmap(fn, x) for x in X)
    return fn(X)


def _msub(X, Y):
    return (
        (X[0][0] - Y[0][0], X[0][1] - Y[0][1]),
        (X[1][0] - Y[1][0], X[1][1] - Y[1][1]),
    )


def _outer(u, v):
    return (
        (u[0] * v[0], u[0] * v[1]),
        (u[1] * v[0], u[1] * v[1]),
    )


def rts_elements(Ft, ct, Qt, m_f, P_f, track_end):
    """The RTS smoothing elements of rts_smoother_soa (time order), the
    unmasked gains G and the predictive covariances Pp of the next step,
    all in LEAVING indexing (slot i: the transition i -> i+1)."""
    # transition LEAVING step i = transition entering i+1 (identity
    # fills on the diagonal for the final slot)
    Fn = (
        (_shift_back(Ft[0][0], 1.0), _shift_back(Ft[0][1])),
        (_shift_back(Ft[1][0]), _shift_back(Ft[1][1], 1.0)),
    )
    cn = (_shift_back(ct[0]), _shift_back(ct[1]))
    Qn = _tmap(_shift_back, Qt)

    # prediction of i+1 from filtered i: Pp = F P F' + Q
    FP = _m2(Fn, P_f)
    Pp = _symm(_madd(_m2(FP, _t2(Fn)), Qn))
    # RTS gain G = P F' Pp^{-1}
    G = _m2(_t2(FP), _inv2(Pp))
    g = _vsub(m_f, _mv(G, _vadd(_mv(Fn, m_f), cn)))
    L = _symm(_msub(P_f, _m2(_m2(G, Pp), _t2(G))))

    # absorbing element at track ends: smoothed = filtered
    zero = torch.zeros_like(m_f[0])
    elem = Smooth2(
        E=_wh(track_end, ((zero, zero), (zero, zero)), G),
        g=_wh(track_end, m_f, g),
        L=_wh(track_end, P_f, L),
    )
    return elem, G, Pp


def rts_smoother_soa(Ft, ct, Qt, m_f, P_f, track_end, scan="auto"):
    """Smoothed moments from filtered moments.

    Ft, ct, Qt: the transition ENTERING each step (kalman_soa
    convention); m_f (2-tuple), P_f (2x2 tuple): filtered moments;
    track_end: bool, broadcastable to the moments, the last index of each
    track. Returns (m_s 2-tuple, P_s 2x2 tuple, G 2x2 tuple) with G[i]
    the RTS gain of the i -> i+1 recursion (lag-one cross-covariance
    Cov(x_{i+1}, x_i | y) = P_s_{i+1} G_i')."""
    elem, G, _ = rts_elements(Ft, ct, Qt, m_f, P_f, track_end)
    scanned = _scan_elements(_combine2_rev, _ID_S2, elem, scan, reverse=True)
    return scanned.g, scanned.L, G


def _unbroadcast(cot, like):
    """Sum a (d, n) cotangent down to its primal's shape."""
    shape = like.shape
    while cot.dim() > len(shape):
        cot = cot.sum(0)
    for ax, (c, s) in enumerate(zip(cot.shape, shape)):
        if s == 1 and c != 1:
            cot = cot.sum(ax, keepdim=True)
    return cot.reshape(shape)


def _analytic_score(sys, m_f, P_f, gbar, scan):
    """Fisher-identity cotangents (Fbar, cbar, Qbar, ybar, hbar) of
    (Ft, ct, Qt, yd, h), leaves (d, n), from the filtered moments: the RTS
    smoother through `_scan_elements(scan)` and the elementwise score.

    The score is the JAX package's (kalman_smooth.py:208-287), with
    r = x_i - F x_{i-1} - c,

        Fbar = Qinv E[r x_{i-1}'],  cbar = Qinv E[r],
        Qbar = (Qinv E[r r'] Qinv - Qinv) / 2,

    written without Qinv: with the predictive moments m_pred = F m_{i-1} +
    c, Pp = F P_{i-1} F' + Q and the RTS gain G_{i-1} = P_{i-1} F' Pp^-1
    of the same filter, I - F G = Q Pp^-1, so Qinv E[r] = Pp^-1 dm with
    dm = m_s - m_pred, and

        Fbar = Pp^-1 ((P_s - Pp) G' + dm m_{s,i-1}'),
        Qbar = Pp^-1 (P_s - Pp + dm dm') Pp^-1 / 2.

    Equal in exact arithmetic; in f32 the JAX form loses Q's smallness to
    cancellation (Qinv E Qinv - Qinv, with Q ~ dt^3 small): on the CPU its
    per-step gradient is 1.5e-5 of the largest component off the f64
    value at the median of nine test shapes and 7.2e-4 at the worst,
    this form 3.4e-7 and 1.4e-6."""
    Ft, ct, Qt, yd, h = sys.Ft, sys.ct, sys.Qt, sys.yd, sys.h
    reset, update = sys.reset, sys.update
    te = torch.cat([reset[1:], reset.new_ones(1)])
    elem, G, Pp = rts_elements(Ft, ct, Qt, m_f, P_f, te)
    sm = _scan_elements(_combine2_rev, _ID_S2, elem, scan, reverse=True)
    m_s, P_s = sm.g, sm.L

    # values at i - 1 in slot i: the smoothed mean, the gain, and the
    # prediction of step i from the filter at i - 1
    m1, Gp, Pp = _tmap(_shift, m_s), _tmap(_shift, G), _tmap(_shift, Pp)
    dm = _vsub(m_s, _vadd(_mv(Ft, _tmap(_shift, m_f)), ct))
    tv = ~reset & ~sys.prev_reset  # the transition has a density
    one, zero = torch.ones_like(yd), torch.zeros_like(yd)
    Ppi = _inv2(_wh(tv, Pp, ((one, zero), (zero, one))))  # sanitized
    D = _msub(P_s, Pp)

    Fbar = _m2(Ppi, _madd(_m2(D, _t2(Gp)), _outer(dm, m1)))
    cbar = _mv(Ppi, dm)
    Qbar = _tmap(lambda x: 0.5 * x,
                 _m2(_m2(Ppi, _madd(D, _outer(dm, dm))), Ppi))

    def scaled(X):
        return _tmap(lambda x: gbar * torch.where(tv, x, 0.0), X)

    resid = yd - m_s[0]
    ybar = gbar * (torch.where(update, -resid / h, 0.0)
                   + torch.where(reset, -resid / sys.p0_pos, 0.0))
    Ey2 = resid * resid + P_s[0][0]
    hbar = gbar * torch.where(update, 0.5 * Ey2 / (h * h) - 0.5 / h,
                              0.0).sum()
    return scaled(Fbar), scaled(cbar), scaled(Qbar), ybar, hbar


def _flatten(Ft, ct, Qt, yd, h):
    return (Ft[0][0], Ft[0][1], Ft[1][0], Ft[1][1], ct[0], ct[1],
            Qt[0][0], Qt[0][1], Qt[1][0], Qt[1][1], yd, h)


def _unflatten(v):
    return (((v[0], v[1]), (v[2], v[3])), (v[4], v[5]),
            ((v[6], v[7]), (v[8], v[9])), v[10], v[11])


class Llk2Analytic(torch.autograd.Function):
    """CTCRW SoA log-likelihood with the Fisher-identity gradient, over
    the flattened (Ft, ct, Qt, yd, h) of a CtcrwSystem (the JAX package's
    custom_vjp `core` of `llk2_analytic`). Arguments: (sys, scan, *the 12
    components in `_flatten` order); sys supplies the masks and priors."""

    @staticmethod
    def forward(ctx, sys, scan, *comps):
        Ft, ct, Qt, yd, h = _unflatten(comps)
        sys2 = sys._replace(Ft=Ft, ct=ct, Qt=Qt, yd=yd, h=h, elem=None)
        if scan == "fused":
            from smoothsde_tpu_torch.ops.ctcrw_fused import fused_filter

            # moments stay in the kernels' lane layout for the backward
            llk, moments = fused_filter(sys2)
            mom = (moments,)
        else:
            elem = _build_elem2(Ft, ct, Qt, yd, h, sys.reset, sys.update,
                                sys.p0_pos, sys.p0_vel)
            sc = _scan_elements(_combine2, _ID2, elem, scan)
            llk = _llk_from_filtered(sys2, sc.b, sc.C)
            mom = (sc.b[0], sc.b[1], sc.C[0][0], sc.C[0][1], sc.C[1][1])
        ctx.save_for_backward(*comps, *mom)
        ctx.sys = sys._replace(Ft=None, ct=None, Qt=None, yd=None, h=None,
                               elem=None)
        ctx.scan = scan
        return llk

    @staticmethod
    def backward(ctx, gbar):
        saved = ctx.saved_tensors
        comps, mom = saved[:12], saved[12:]
        Ft, ct, Qt, yd, h = _unflatten(comps)
        sys2 = ctx.sys._replace(Ft=Ft, ct=ct, Qt=Qt, yd=yd, h=h)
        if ctx.scan == "fused":
            from smoothsde_tpu_torch.ops.ctcrw_fused import fused_backward

            bars = fused_backward(sys2, mom[0], gbar)
        else:
            m_f = (mom[0], mom[1])
            P_f = ((mom[2], mom[3]), (mom[3], mom[4]))
            bars = _analytic_score(sys2, m_f, P_f, gbar, ctx.scan)
        cots = [_unbroadcast(c, x) for c, x in zip(_flatten(*bars), comps)]
        return (None, None, *cots)


def llk2_analytic(sys, scan: str = "auto"):
    """CTCRW log-likelihood of a CtcrwSystem (ops/kalman_soa.py
    `_ctcrw_system`), differentiable in its (Ft, ct, Qt, yd, h) through
    the Fisher-identity backward. scan="fused": the element-space fused
    kernels (forward K4a, K2, K4b; backward K5a, K2, K5b); any other
    scan: the filter and the RTS smoother through `_scan_elements`.

    The fused backward returns zero cotangents for Ft[0][0] and Ft[1][0]
    (both constant in the model, as in the JAX package); the other scans
    return the full score."""
    return Llk2Analytic.apply(sys, scan, *_flatten(sys.Ft, sys.ct, sys.Qt,
                                                    sys.yd, sys.h))


def ctcrw_smoothed_states(par_mat, obs, times, ids, sigma_obs,
                          p0_pos=1.0, p0_vel=10.0, scan: str = "auto"):
    """User-facing: smoothed (position, velocity) means and covariances
    per dimension for a CTCRW model. Returns (means (d, n, 2),
    covs (d, n, 2, 2)) on par_mat's device. scan="auto" is the fast
    blocked scan of the device (the phase-1 kernel K8 on a CUDA device)."""
    from smoothsde_tpu_torch.ops.kalman_soa import _ctcrw_system

    sys = _ctcrw_system(par_mat, obs, times, ids, sigma_obs, p0_pos, p0_vel)
    scanned = _scan_elements(_combine2, _ID2, sys.elem, scan)
    track_end = torch.cat([sys.reset[1:], sys.reset.new_ones(1)])
    m_s, P_s, _ = rts_smoother_soa(sys.Ft, sys.ct, sys.Qt, scanned.b,
                                   scanned.C, track_end, scan)
    means = torch.stack([m_s[0], m_s[1]], dim=-1)
    covs = torch.stack([
        torch.stack([P_s[0][0], P_s[0][1]], dim=-1),
        torch.stack([P_s[1][0], P_s[1][1]], dim=-1),
    ], dim=-2)
    return means, covs
