"""Cancellation-free forms of the CTCRW and OU covariance expressions, on
tensors.

Port of smoothsde_tpu/ops/stable.py. The reference computes the CTCRW
process-noise entries directly (nllk_ctcrw.hpp:64-75):

    q00 = s^2/b^2 * (dt - 2(1-e^{-b dt})/b + (1-e^{-2 b dt})/(2b))
    q01 = s^2/(2 b^2) * (1 - 2 e^{-b dt} + e^{-2 b dt})

For small u = b*dt the parenthesized factors are O(u^3) and O(u^2)
built from O(u) terms, which costs 3-4 digits in float32. The
identities used here:

    em1(u) = 1 - e^{-u}                      (exact via expm1)
    q01 factor = em1(u)^2
    1 - e^{-2u} = em1(u) * (1 + e^{-u})
    q00 factor = phi(u) = psi(u) - em1(u)^2/2, psi(u) = u - em1(u),
        with Taylor-series branches below u < 0.6.

Every function takes an array module `xp` (torch by default; numpy for
host-side use, e.g. utils/misc.ctcrw_cov). The Taylor tables are the
JAX package's, verbatim.
"""

from __future__ import annotations

import torch

# Taylor coefficients of psi(u) = u - (1 - e^{-u}) = sum_{k>=2} (-u)^k/k!
# (low order first, factored as u^2 * poly(u)).
_PSI_COEFFS = (
    1.0 / 2.0,
    -1.0 / 6.0,
    1.0 / 24.0,
    -1.0 / 120.0,
    1.0 / 720.0,
    -1.0 / 5040.0,
    1.0 / 40320.0,
    -1.0 / 362880.0,
    1.0 / 3628800.0,
    -1.0 / 39916800.0,
    1.0 / 479001600.0,
    -1.0 / 6227020800.0,
    1.0 / 87178291200.0,
    -1.0 / 1307674368000.0,
    1.0 / 20922789888000.0,
)

# Taylor coefficients of phi(u) = u - 2(1-e^{-u}) + (1-e^{-2u})/2
#   = sum_{k>=3} (-1)^{k+1} (2^{k-1}-2)/k! u^k, factored as u^3 * poly(u).
_PHI_COEFFS = (
    1.0 / 3.0,
    -1.0 / 4.0,
    7.0 / 60.0,
    -1.0 / 24.0,
    31.0 / 2520.0,
    -1.0 / 320.0,
    127.0 / 181440.0,
    -17.0 / 120960.0,
    511.0 / 19958400.0,
    -1023.0 / 239500800.0,
    4094.0 / 6227020800.0,
    -8190.0 / 87178291200.0,
    16382.0 / 1307674368000.0,
    -32766.0 / 20922789888000.0,
    65534.0 / 355687428096000.0,
    -131070.0 / 6402373705728000.0,
)

# Below the cutoff the regrouped direct forms lose ~3 eps / u^2 of
# relative accuracy; the truncated series at the cutoff is accurate to
# < 1e-14 (f64) with the terms above. csrc/ctcrw_common.cuh uses the
# same cutoff and tables.
_SERIES_CUTOFF = 0.6


def _horner(u, coeffs):
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * u + c
    return acc


def em1(u, xp=torch):
    """1 - e^{-u}, exact for small u."""
    return -xp.expm1(-u)


def psi(u, xp=torch):
    """u - (1 - e^{-u}) ~ u^2/2: the CTCRW position-drift factor."""
    direct = u - em1(u, xp)
    series = u * u * _horner(u, _PSI_COEFFS)
    return xp.where(u < _SERIES_CUTOFF, series, direct)


def phi(u, xp=torch):
    """u - 2(1-e^{-u}) + (1-e^{-2u})/2 ~ u^3/3: the CTCRW position
    process-noise factor q00 * b^3 / s^2."""
    m = em1(u, xp)
    direct = (u - m) - 0.5 * m * m
    series = u * u * u * _horner(u, _PHI_COEFFS)
    return xp.where(u < _SERIES_CUTOFF, series, direct)


def em1_psi_phi_kernel(u, xp=torch):
    """(e1, em1, psi, phi) without the expm1 primitive: em1 from its
    series below the cutoff (em1 = u - psi_series) and from 1 - e^{-u}
    above it. Kept for parity with the JAX package, whose TPU kernels
    had no expm1; the CUDA kernels and their plain versions use
    `em1`/`psi`/`phi`, which agree with this to ~1 ulp."""
    e1 = xp.exp(-u)
    m1d = 1.0 - e1
    ps = u * u * _horner(u, _PSI_COEFFS)
    ph = u * u * u * _horner(u, _PHI_COEFFS)
    small = u < _SERIES_CUTOFF
    m1 = xp.where(small, u - ps, m1d)
    psi_v = xp.where(small, ps, u - m1d)
    phi_v = xp.where(small, ph, (u - m1d) - 0.5 * m1d * m1d)
    return e1, m1, psi_v, phi_v


def ctcrw_transition_terms(beta, sigma2, dt, xp=torch):
    """All CTCRW per-step transition/noise pieces in stable form.

    Returns a dict (elementwise over the broadcast of beta/dt):
      e1  = e^{-beta dt}                  T[1,1]
      g   = (1 - e1)/beta                 T[0,1]
      q00 = s^2/b^3 * phi(u)              Q[0,0]
      q01 = s^2/(2 b^2) * em1(u)^2        Q[0,1]
      q11 = s^2/(2 b) * em1(u)(1 + e1)    Q[1,1]
      bp  = psi(u)/beta                   position drift factor (dt - g)
      bv  = em1(u)                        velocity drift factor (1 - e1)
    """
    u = beta * dt
    e1 = xp.exp(-u)
    m1 = em1(u, xp)
    g = m1 / beta
    q00 = sigma2 / (beta * beta * beta) * phi(u, xp)
    q01 = sigma2 / (2.0 * beta * beta) * (m1 * m1)
    q11 = sigma2 / (2.0 * beta) * (m1 * (1.0 + e1))
    bp = psi(u, xp) / beta
    bv = m1
    return {
        "e1": e1,
        "g": g,
        "q00": q00,
        "q01": q01,
        "q11": q11,
        "bp": bp,
        "bv": bv,
    }


def ou_transition_terms(tau, dt, xp=torch):
    """OU per-step pieces (nllk_ou_ssm.hpp:31-69), elementwise:
      decay = e^{-dt/tau}                  transition
      bfac  = em1(u) = 1 - decay            drift factor (times mu)
      qfac  = em1(u)(1 + decay)             noise factor 1 - decay^2 (times
                                            kappa), without the cancellation
                                            of 1 - decay^2 at small dt/tau
    """
    u = dt / tau
    decay = xp.exp(-u)
    m1 = em1(u, xp)
    return {"decay": decay, "bfac": m1, "qfac": m1 * (1.0 + decay)}
