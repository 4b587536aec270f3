"""Square-root (Cholesky-form) associative Kalman filtering: the CTCRW
(state dim 2 per response dim) and BM_SSM / OU_SSM (state dim 1)
log-likelihoods through factor-form filtering elements.

Port of smoothsde_tpu/ops/kalman_sqrt.py. The moment-form elements carry
covariance-like blocks (C, the filtered covariance contribution; J, the
information contribution) whose f32 composition over ~1e6 steps
accumulates rounding in their small entries; propagating Cholesky
FACTORS instead (U with C = U U', Z with J = Z Z') keeps the small
covariances accurate to a few ulp of the factor (the parallel
square-root elements of Yaghoobi, Corenflos, Hassan & Sarkka). With
K = U1' Z2 and Lt = chol(I + K' K), Lh = chol(I + K K'):

  U_new = tria([A2 U1 Lh^{-T} | U2]),  Z_new = tria([A1' Z2 Lt^{-T} | Z1]),
  M = I - W V',  W = U1 K Lt^{-T},  V = Z2 Lt^{-T},

and A, b, eta as in the moment form through M. `tria` is the
closed-form LQ of a 2 x 4 row block (Gram-Schmidt on two rows), never
forming a Gram matrix. Every operation is elementwise over the step /
lane axis (the SoA layout of ops/kalman_soa.py).

`_ssqrt` and `_sdiv` guard the masked branches: padding and masked
elements carry exact zero factors, where d sqrt / dx = inf and 0 / 0
would NaN-poison gradients; `_sdiv(0, 0)` is 0.

The scans go through ops/kalman_soa.py `_scan_elements`: "pallas" runs
the phase-1 kernel K8 and the cross-block prefix K2 on their `sqrt2` /
`sqrt1` instantiations (csrc/sqrt_common.cuh) for CUDA tensors,
forward-only (a gradient through them raises); "blocked",
"associative" and "sequential" are plain torch and differentiate by
autograd (the fits take "blocked" on a card and "sequential" on the
CPU, infer/objective.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smoothsde_tpu_torch.ops.kalman_soa import (
    CtcrwSystem,
    _ctcrw_system,
    _scan_elements,
    _shift,
    _wh,
)


def _ssqrt(x):
    """sqrt with a zero-safe gradient (masked branches carry exact
    zeros; d sqrt / dx at 0 is inf)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _sdiv(a, b):
    """a / b, and 0 where b == 0."""
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, 1.0), 0.0)


class SqrtElement2(NamedTuple):
    """SoA square-root filtering element for state dim 2: A a 2x2 nested
    tuple, b and eta 2-tuples, U and Z lower-triangular factors stored as
    (l00, l10, l11) with C = U U', J = Z Z'."""

    A: tuple
    b: tuple
    U: tuple
    eta: tuple
    Z: tuple


_ID_SQ2 = SqrtElement2(
    A=((1.0, 0.0), (0.0, 1.0)),
    b=(0.0, 0.0),
    U=(0.0, 0.0, 0.0),
    eta=(0.0, 0.0),
    Z=(0.0, 0.0, 0.0),
)


def _chol2(g00, g01, g11):
    """Closed-form Cholesky (l00, l10, l11) of a 2x2 SPD matrix."""
    l00 = torch.sqrt(g00)
    l10 = g01 / l00
    l11 = torch.sqrt(g11 - l10 * l10)
    return l00, l10, l11


def _tria24(r1, r2):
    """Closed-form LQ of a 2 x m row block: the lower-triangular
    (l00, l10, l11) with [r1; r2] [r1; r2]' = L L'. Zero rows are safe
    (masked elements)."""
    l00 = _ssqrt(sum(x * x for x in r1))
    q1 = tuple(_sdiv(x, l00) for x in r1)
    l10 = sum(a * b for a, b in zip(r2, q1))
    w = tuple(a - l10 * b for a, b in zip(r2, q1))
    return l00, l10, _ssqrt(sum(x * x for x in w))


def _combine_sqrt2(e1: SqrtElement2, e2: SqrtElement2) -> SqrtElement2:
    """Square-root filtering combine, e1 the earlier steps."""
    A1, b1, (p00, p10, p11), eta1, Z1 = e1
    A2, b2, U2, eta2, (w00, w10, w11) = e2

    # K = U1' Z2 (U1' upper, Z2 lower)
    k00 = p00 * w00 + p10 * w10
    k01 = p10 * w11
    k10 = p11 * w10
    k11 = p11 * w11

    # Lt = chol(I + K'K); V = Z2 Lt^{-T}; W = U1 K Lt^{-T}
    t00, t10, t11 = _chol2(1.0 + k00 * k00 + k10 * k10,
                           k00 * k01 + k10 * k11,
                           1.0 + k01 * k01 + k11 * k11)
    # Lt^{-T} (upper): [[1/t00, -t10/(t00 t11)], [0, 1/t11]]
    iu00 = 1.0 / t00
    iu01 = -t10 / (t00 * t11)
    iu11 = 1.0 / t11
    V = ((w00 * iu00, w00 * iu01), (w10 * iu00, w10 * iu01 + w11 * iu11))
    uk00 = p00 * k00
    uk01 = p00 * k01
    uk10 = p10 * k00 + p11 * k10
    uk11 = p10 * k01 + p11 * k11
    W = ((uk00 * iu00, uk00 * iu01 + uk01 * iu11),
         (uk10 * iu00, uk10 * iu01 + uk11 * iu11))

    def m_apply(v0, v1):
        """(I - W V') v"""
        s0 = V[0][0] * v0 + V[1][0] * v1
        s1 = V[0][1] * v0 + V[1][1] * v1
        return (v0 - (W[0][0] * s0 + W[0][1] * s1),
                v1 - (W[1][0] * s0 + W[1][1] * s1))

    def mt_apply(v0, v1):
        """(I - V W') v"""
        s0 = W[0][0] * v0 + W[1][0] * v1
        s1 = W[0][1] * v0 + W[1][1] * v1
        return (v0 - (V[0][0] * s0 + V[0][1] * s1),
                v1 - (V[1][0] * s0 + V[1][1] * s1))

    # A = A2 M A1: M applied to each column of A1
    c0 = m_apply(A1[0][0], A1[1][0])
    c1 = m_apply(A1[0][1], A1[1][1])
    A = ((A2[0][0] * c0[0] + A2[0][1] * c0[1],
          A2[0][0] * c1[0] + A2[0][1] * c1[1]),
         (A2[1][0] * c0[0] + A2[1][1] * c0[1],
          A2[1][0] * c1[0] + A2[1][1] * c1[1]))

    # b = A2 M (b1 + C1 eta2) + b2, C1 eta2 = U1 (U1' eta2)
    s0 = p00 * eta2[0] + p10 * eta2[1]
    s1 = p11 * eta2[1]
    mt0, mt1 = m_apply(b1[0] + p00 * s0, b1[1] + p10 * s0 + p11 * s1)
    b = (A2[0][0] * mt0 + A2[0][1] * mt1 + b2[0],
         A2[1][0] * mt0 + A2[1][1] * mt1 + b2[1])

    # eta = A1' M' (eta2 - J2 b1) + eta1, J2 b1 = Z2 (Z2' b1)
    zb0 = w00 * b1[0] + w10 * b1[1]
    zb1 = w11 * b1[1]
    nq0, nq1 = mt_apply(eta2[0] - w00 * zb0,
                        eta2[1] - (w10 * zb0 + w11 * zb1))
    eta = (A1[0][0] * nq0 + A1[1][0] * nq1 + eta1[0],
           A1[0][1] * nq0 + A1[1][1] * nq1 + eta1[1])

    # U = tria([A2 U1 Lh^{-T} | U2]), Lh = chol(I + K K')
    h00, h10, h11 = _chol2(1.0 + k00 * k00 + k01 * k01,
                           k00 * k10 + k01 * k11,
                           1.0 + k10 * k10 + k11 * k11)
    ju00 = 1.0 / h00
    ju01 = -h10 / (h00 * h11)
    ju11 = 1.0 / h11
    y00 = p00 * ju00  # Y = U1 Lh^{-T}
    y01 = p00 * ju01
    y10 = p10 * ju00
    y11 = p10 * ju01 + p11 * ju11
    ay00 = A2[0][0] * y00 + A2[0][1] * y10
    ay01 = A2[0][0] * y01 + A2[0][1] * y11
    ay10 = A2[1][0] * y00 + A2[1][1] * y10
    ay11 = A2[1][0] * y01 + A2[1][1] * y11
    U = _tria24((ay00, ay01, U2[0], 0.0 * ay00),
                (ay10, ay11, U2[1], U2[2]))

    # Z = tria([A1' V | Z1])  (A1' Z2 Lt^{-T} = A1' V)
    av00 = A1[0][0] * V[0][0] + A1[1][0] * V[1][0]
    av01 = A1[0][0] * V[0][1] + A1[1][0] * V[1][1]
    av10 = A1[0][1] * V[0][0] + A1[1][1] * V[1][0]
    av11 = A1[0][1] * V[0][1] + A1[1][1] * V[1][1]
    Z = _tria24((av00, av01, Z1[0], 0.0 * av00),
                (av10, av11, Z1[1], Z1[2]))
    return SqrtElement2(A=A, b=b, U=U, eta=eta, Z=Z)


def _build_sqrt_elements(sys: CtcrwSystem) -> SqrtElement2:
    """Per-step square-root elements from the CTCRW system (the
    reset / update / propagate select of `_ctcrw_system`, with factors
    in place of C and J)."""
    Ft, ct, Qt, yd, h = sys.Ft, sys.ct, sys.Qt, sys.yd, sys.h
    reset, upd = sys.reset, sys.update & ~sys.reset

    q00, q01, q11 = Qt[0][0], Qt[0][1], Qt[1][1]
    # chol(Qt), zero-safe for masked (zero) steps
    uq00 = _ssqrt(q00)
    uq10 = _sdiv(q01, uq00)
    uq11 = _ssqrt(q11 - uq10 * uq10)

    S = q00 + h
    K0 = q00 / S
    K1 = q01 / S
    r = yd - ct[0]
    f0, f1 = Ft[0][0], Ft[0][1]

    # measurement update in factor form: C_upd = Uq diag(sqrt(h/S), 1) Uq'
    sh = torch.sqrt(h / S)
    u_upd = (uq00 * sh, uq10 * sh, uq11)
    A_upd = (((1.0 - K0) * f0, (1.0 - K0) * f1),
             (Ft[1][0] - K1 * f0, Ft[1][1] - K1 * f1))
    b_upd = (ct[0] + K0 * r, ct[1] + K1 * r)
    eta_upd = (f0 * r / S, f1 * r / S)
    # J_upd = (Ft' z)(Ft' z)' / S: the rank-1 factor as lower storage
    rs = 1.0 / torch.sqrt(S)
    z0 = torch.zeros_like(f0)
    z_upd = _tria24((f0 * rs, z0, z0, z0), (f1 * rs, z0, z0, z0))

    zero = torch.zeros_like(yd)
    p0p = torch.full_like(yd, sys.p0_pos ** 0.5)
    p0v = torch.full_like(yd, sys.p0_vel ** 0.5)
    return SqrtElement2(
        A=_wh(reset, ((zero, zero), (zero, zero)), _wh(upd, A_upd, Ft)),
        b=_wh(reset, (yd, zero), _wh(upd, b_upd, ct)),
        U=_wh(reset, (p0p, zero, p0v), _wh(upd, u_upd, (uq00, uq10, uq11))),
        eta=_wh(upd, eta_upd, (zero, zero)),
        Z=_wh(upd, z_upd, (zero, zero, zero)),
    )


def _llk_from_sqrt_filtered(sys: CtcrwSystem, m_f, U_f):
    """Predictive llk from square-root filtered moments: Pp00 =
    || row 0 of Ft U_prev ||^2 + q00, a sum of squares (no
    cancellation)."""
    Ft, ct, Qt, yd, h = sys.Ft, sys.ct, sys.Qt, sys.yd, sys.h
    m0p, m1p = _shift(m_f[0]), _shift(m_f[1])
    u00p, u10p, u11p = _shift(U_f[0]), _shift(U_f[1]), _shift(U_f[2])
    f0, f1 = Ft[0][0], Ft[0][1]
    r0 = f0 * u00p + f1 * u10p
    r1 = f1 * u11p
    Pp00 = r0 * r0 + r1 * r1 + Qt[0][0]
    a_pred0 = torch.where(sys.reset, yd, f0 * m0p + f1 * m1p + ct[0])
    Pp00 = torch.where(sys.reset, sys.p0_pos, Pp00)
    F = Pp00 + h
    u = yd - a_pred0
    return torch.where(sys.update, -0.5 * (torch.log(F) + u * u / F),
                       0.0).sum()


class SqrtElement1(NamedTuple):
    """SoA square-root filtering element for state dim 1: scalars with
    C = u^2, J = z^2 (the s = 1 case of SqrtElement2)."""

    A: torch.Tensor
    b: torch.Tensor
    u: torch.Tensor
    eta: torch.Tensor
    z: torch.Tensor


_ID_SQ1 = SqrtElement1(A=1.0, b=0.0, u=0.0, eta=0.0, z=0.0)


def _combine_sqrt1(e1: SqrtElement1, e2: SqrtElement1) -> SqrtElement1:
    """Scalar square-root combine: with k = u1 z2 and M = 1/(1 + k^2),
    u_new^2 = A2^2 M u1^2 + u2^2 and z_new^2 = A1^2 M z2^2 + z1^2,
    through the factors (sums of squares, no cancellation)."""
    A1, b1, u1, eta1, z1 = e1
    A2, b2, u2, eta2, z2 = e2
    k = u1 * z2
    M = 1.0 / (1.0 + k * k)
    sM = torch.sqrt(M)
    A = A2 * M * A1
    b = A2 * M * (b1 + u1 * (u1 * eta2)) + b2
    au = A2 * u1 * sM
    u = _ssqrt(au * au + u2 * u2)
    eta = A1 * M * (eta2 - z2 * (z2 * b1)) + eta1
    az = A1 * z2 * sM
    z = _ssqrt(az * az + z1 * z1)
    return SqrtElement1(A=A, b=b, u=u, eta=eta, z=z)


def _build_sqrt_elements1(sysd) -> SqrtElement1:
    """Per-step scalar square-root elements from a DiagSystem (the select
    of ops/diag_fused.diag_elements, with u = sqrt(C), z = sqrt(J))."""
    t, q, c, yd, h = sysd.t, sysd.q, sysd.c, sysd.yd, sysd.h
    reset, update = sysd.resetf > 0.5, sysd.updatef > 0.5
    S = q + h
    K = q / S
    r = yd - c
    # update: C = (1 - K) q = q h / S -> u = sqrt(q) sqrt(h / S);
    # J = t^2 / S -> z = |t| / sqrt(S)
    rootS = torch.sqrt(S)
    zero = torch.zeros_like(yd)
    return SqrtElement1(
        A=_wh(reset, zero, _wh(update, (1.0 - K) * t, t)),
        b=_wh(reset, yd, _wh(update, c + K * r, c)),
        u=_wh(reset, torch.full_like(yd, sysd.p0 ** 0.5),
              _wh(update, _ssqrt(q) * torch.sqrt(h) / rootS, _ssqrt(q))),
        eta=_wh(update, t * r / S, zero),
        z=_wh(update, torch.abs(t) / rootS, zero),
    )


def _llk_from_sqrt_filtered1(sysd, m_f, u_f):
    """Predictive llk from scalar square-root filtered moments: P_pred =
    (t u_prev)^2 + q, a sum of squares."""
    reset = sysd.resetf > 0.5
    tu = sysd.t * _shift(u_f)
    a_pred = torch.where(reset, sysd.yd, sysd.t * _shift(m_f) + sysd.c)
    P_pred = torch.where(reset, sysd.p0, tu * tu + sysd.q)
    F = P_pred + sysd.h
    r = sysd.yd - a_pred
    return torch.where(sysd.updatef > 0.5,
                       -0.5 * (torch.log(F) + r * r / F), 0.0).sum()


def diag_ssm_loglik_sqrt(type, par_mat, obs, times, ids, sigma_obs, p0=10.0,
                         scan: str = "auto", data=None):
    """BM_SSM / OU_SSM log-likelihood through the scalar square-root
    filter (reference loops nllk_bm_ssm.hpp:127-175,
    nllk_ou_ssm.hpp:163-213); the value of
    ops/kalman_soa.diag_ssm_loglik_soa to roundoff. Pass `data`
    (ops/diag_fused.prepare_diag_data of the same type) to skip
    rebuilding the per-step data; obs/times/ids are then unused."""
    from smoothsde_tpu_torch.ops.diag_fused import diag_system

    sysd = diag_system(type, par_mat, obs, times, ids, sigma_obs, p0=p0,
                       data=data)
    scanned = _scan_elements(_combine_sqrt1, _ID_SQ1,
                             _build_sqrt_elements1(sysd), scan)
    return _llk_from_sqrt_filtered1(sysd, scanned.b, scanned.u)


def ctcrw_loglik_sqrt(par_mat, obs, times, ids, sigma_obs, p0_pos=1.0,
                      p0_vel=10.0, scan: str = "auto", data=None):
    """CTCRW log-likelihood through the square-root filter: the value of
    ops/kalman_soa.ctcrw_loglik_soa to roundoff, with much tighter
    long-horizon f32 accuracy. scan: "blocked", "pallas", "associative",
    "sequential" or "auto" (`_scan_elements`). Pass `data`
    (prepare_ctcrw_data) to skip rebuilding the per-step data."""
    over = {}
    if data is not None:
        over = dict(dt=data.dtv, yd=data.yd, reset=data.resetf > 0.5,
                    valid=data.validf > 0.5)
    sys = _ctcrw_system(par_mat, obs, times, ids, sigma_obs, p0_pos, p0_vel,
                        **over)
    scanned = _scan_elements(_combine_sqrt2, _ID_SQ2,
                             _build_sqrt_elements(sys), scan)
    return _llk_from_sqrt_filtered(sys, scanned.b, scanned.U)
