"""Exact simulation of SDE sample paths given per-row parameter values.

Mirrors the per-type schemes of the reference (R/sde.R:1421-1501):
BM via vectorized Gaussian increments, OU via exact sequential
transitions, CTCRW via the joint (V, Z) Gaussian transition with
ctcrw_cov, CIR via noncentral chi-square draws. The reference's CIR
branch has two latent defects deliberately NOT reproduced (loop bound
using the global n, R/sde.R:1487, and a vector-valued beta in the
exponent, R/sde.R:1491) — SURVEY.md section 3.4.

Port of smoothsde_tpu/api/simulate.py (NumPy only, on the port's
utils/misc.ctcrw_cov): the same draws from the same generator.
"""

from __future__ import annotations

import numpy as np

from smoothsde_tpu_torch.utils.misc import ctcrw_cov


def simulate_paths(
    type: str,
    par: np.ndarray,  # (n, n_par) response-scale parameters
    times: np.ndarray,
    ids: np.ndarray,
    n_dim: int,
    z0,
    rng: np.random.Generator,
    sigma_obs: float = None,
) -> np.ndarray:
    """Simulate all response dims for all tracks. Returns (n, n_dim).

    BM_SSM/OU_SSM (beyond the reference, which raises for SSM types):
    the exact latent BM/OU path plus iid N(0, sigma_obs^2) measurement
    error (nllk_bm_ssm.hpp / nllk_ou_ssm.hpp observation equations).
    CTCRW simulates the latent position process, as in the reference
    (R/sde.R:1449-1478).
    """
    if type in ("BM_SSM", "OU_SSM"):
        if sigma_obs is None:
            raise ValueError(
                f"simulating {type} requires sigma_obs (measurement SD)"
            )
        latent = simulate_paths(
            type[:2] if type == "BM_SSM" else "OU",
            par, times, ids, n_dim, z0, rng,
        )
        return latent + rng.normal(0.0, sigma_obs, size=latent.shape)
    n = len(times)
    z0 = np.asarray(z0, float).reshape(-1)
    if z0.size < n_dim:
        z0 = np.resize(z0, n_dim)  # recycle like R's rep() (R/sde.R:1418-1420)
    out = np.full((n, n_dim), np.nan)
    for d in range(n_dim):
        for uid in np.unique(ids):
            ind = np.where(ids == uid)[0]
            sub_n = len(ind)
            t = times[ind]
            dt = np.diff(t)
            p = par[ind]
            if type == "BM":
                mean = p[:-1, d] * dt
                sd = p[:-1, n_dim] * np.sqrt(dt)
                incr = rng.normal(mean, sd) if sub_n > 1 else np.zeros(0)
                out[ind, d] = np.concatenate([[z0[d]], z0[d] + np.cumsum(incr)])
            elif type == "OU":
                x = np.empty(sub_n)
                x[0] = z0[d]
                mu = p[:, d]
                tau = p[:, n_dim]
                kappa = p[:, n_dim + 1]
                for i in range(1, sub_n):
                    e = np.exp(-dt[i - 1] / tau[i - 1])
                    mean = e * x[i - 1] + (1.0 - e) * mu[i - 1]
                    sd = np.sqrt(kappa[i - 1] * (1.0 - e * e))
                    x[i] = rng.normal(mean, sd)
                out[ind, d] = x
            elif type == "CTCRW":
                mu = p[:, d]
                tau = p[:, n_dim]
                nu = p[:, n_dim + 1]
                beta = 1.0 / tau
                sigma = 2.0 * nu / np.sqrt(np.pi * tau)
                v, z = 0.0, z0[d]
                zs = np.empty(sub_n)
                zs[0] = z
                for i in range(1, sub_n):
                    b, s = beta[i - 1], sigma[i - 1]
                    e = np.exp(-b * dt[i - 1])
                    mean_v = e * v + (1.0 - e) * mu[i - 1]
                    mean_z = z + mu[i - 1] * dt[i - 1] + (v - mu[i - 1]) / b * (
                        1.0 - e
                    )
                    V = ctcrw_cov(b, s, dt[i - 1])  # (V, Z) order
                    draw = rng.multivariate_normal([mean_v, mean_z], V)
                    v, z = draw
                    zs[i] = z
                out[ind, d] = zs
            elif type == "CIR":
                mu = p[:, d]
                beta = p[:, n_dim]
                sigma = p[:, n_dim + 1]
                x = np.empty(sub_n)
                x[0] = z0[d]
                for i in range(1, sub_n):
                    b, s = beta[i - 1], sigma[i - 1]
                    c = 2.0 * b / ((1.0 - np.exp(-b * dt[i - 1])) * s * s)
                    df = 4.0 * b * mu[i - 1] / (s * s)
                    ncp = 2.0 * c * x[i - 1] * np.exp(-b * dt[i - 1])
                    x[i] = rng.noncentral_chisquare(df, ncp) / (2.0 * c)
                out[ind, d] = x
            else:
                raise NotImplementedError(
                    f"Simulation not implemented for {type} model"
                )
    return out
