"""Closed-form SDE transition log-densities, vectorized over time steps.

Port of smoothsde_tpu/ops/densities.py: the reference's per-step loop
(src/nllk/nllk_sde.hpp:77-84 calling tr_dens, src/nllk/tr_dens.hpp:18-76)
as one map-reduce over all steps in plain torch ops. No scan and no
hand-written kernel: every step's density is independent.

Conventions (identical to the reference):
  - the step from observation i-1 to i uses the parameter row i-1 and
    dt = t_i - t_{i-1} (nllk_sde.hpp:80-81);
  - steps that cross track (ID) boundaries contribute nothing
    (nllk_sde.hpp:79);
  - a dimension with a missing (NaN) start or end value contributes
    nothing (tr_dens.hpp:31);
  - `par` rows are on the WORKING (linear predictor) scale; inverse links
    are applied inside the density, as in tr_dens.hpp.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from smoothsde_tpu_torch.ops.besseli import log_besselI_scaled
from smoothsde_tpu_torch.ops.kalman_soa import precompute_dt

_LOG_2PI = 1.8378770664093453


def _norm_logpdf(x, mean, sd):
    z = (x - mean) / sd
    return -0.5 * (_LOG_2PI + z * z) - torch.log(sd)


def _t_logpdf(x, df):
    """Standard Student-t log-density (matches TMB's dt); df a float."""
    return (
        math.lgamma((df + 1.0) / 2.0)
        - math.lgamma(df / 2.0)
        - 0.5 * math.log(df * math.pi)
        - (df + 1.0) / 2.0 * torch.log1p(x * x / df)
    )


def bm_logdens(Z1, Z0, dt, par, other_data=None):
    """BM: dZ = mu(t) dt + sigma(t) dW. par = (mu_1..mu_d, log sigma).

    Reference: tr_dens.hpp:32-37.
    Shapes: Z1, Z0 (n, d); dt (n,); par (n, d+1). Returns (n, d).
    """
    n_dim = Z1.shape[-1]
    mu = par[..., :n_dim]
    sd = torch.exp(par[..., n_dim : n_dim + 1]) * torch.sqrt(dt)[..., None]
    mean = Z0 + mu * dt[..., None]
    return _norm_logpdf(Z1, mean, sd)


def bm_t_logdens(Z1, Z0, dt, par, other_data):
    """BM with t-distributed increments (1-d). par = (mu, log sigma).

    Reference: tr_dens.hpp:38-44; df passed via other_data (R/sde.R:539-541).
    """
    df = float(other_data["df"])
    mean = par[..., 0:1] * dt[..., None]
    sd = torch.exp(par[..., 1:2]) * torch.sqrt(dt)[..., None]
    scale = sd / math.sqrt(df / (df - 2.0))
    z = (Z1 - Z0 - mean) / scale
    return _t_logpdf(z, df) - torch.log(scale)


def ou_logdens(Z1, Z0, dt, par, other_data=None):
    """OU: dZ = 1/tau (mu - Z) dt + sqrt(2 kappa / tau) dW.

    par = (mu_1..mu_d, log tau, log kappa). Reference: tr_dens.hpp:45-52.
    """
    n_dim = Z1.shape[-1]
    mu = par[..., :n_dim]
    tau = torch.exp(par[..., n_dim : n_dim + 1])
    kappa = torch.exp(par[..., n_dim + 1 : n_dim + 2])
    decay = torch.exp(-dt[..., None] / tau)
    mean = mu + decay * (Z0 - mu)
    sd = torch.sqrt(kappa * (1.0 - decay * decay))
    return _norm_logpdf(Z1, mean, sd)


def cir_logdens(Z1, Z0, dt, par, other_data=None):
    """CIR: dZ = beta (mu - Z) dt + sigma sqrt(Z) dW.

    par = (log mu_1..log mu_d, log beta, log sigma): noncentral-chi^2
    transition evaluated via the stable log I_q. Reference:
    tr_dens.hpp:53-67.
    """
    n_dim = Z1.shape[-1]
    mu = torch.exp(par[..., :n_dim])
    beta = torch.exp(par[..., n_dim : n_dim + 1])
    sigma = torch.exp(par[..., n_dim + 1 : n_dim + 2])
    ebd = torch.exp(-beta * dt[..., None])
    c = 2.0 * beta / ((1.0 - ebd) * sigma * sigma)
    q = 2.0 * beta * mu / (sigma * sigma) - 1.0
    u = c * Z0 * ebd
    v = c * Z1
    # Scaled-Bessel form: with x = 2 sqrt(u v),
    #   -u - v + log I_q(x) = -(sqrt(u)-sqrt(v))^2 + log(I_q(x) e^{-x}),
    # and (sqrt(u)-sqrt(v))^2 = ((u-v)/(sqrt(u)+sqrt(v)))^2 with
    # u - v = c (Z0 e^{-beta dt} - Z1): no x-scale intermediates, so
    # per-step f32 error stays ~1e-6 instead of ~x*eps (a systematic
    # ~1e-4/step bias that sums to O(100) nllk units at 1M steps).
    su = torch.sqrt(u)
    sv = torch.sqrt(v)
    d = c * (Z0 * ebd - Z1) / (su + sv)
    return (
        torch.log(c)
        - d * d
        + q / 2.0 * (torch.log(v) - torch.log(u))
        + log_besselI_scaled(2.0 * su * sv, q)
    )


CLOSED_FORM_LOGDENS = {
    "BM": bm_logdens,
    "BM_t": bm_t_logdens,
    "OU": ou_logdens,
    "CIR": cir_logdens,
}


class ClosedFormData(NamedTuple):
    """Per-step data of `closed_form_loglik`, on the working device and in
    the working dtype: the sanitized step ends z0, z1 (n - 1, d) (1.0 where
    masked), the sanitized intervals dt (n - 1,) (1.0 across tracks) and
    the mask (n - 1, d) of the steps that contribute."""

    z0: torch.Tensor
    z1: torch.Tensor
    dt: torch.Tensor
    mask: torch.Tensor


def prepare_closed_form_data(obs, times, ids, *, dtype, device,
                             dt=None) -> ClosedFormData:
    """The per-step data of a track set, built once per fit. `dt`: the
    length-n host-f64 intervals with a dummy last slot
    (ops/kalman_soa.precompute_dt); computed from `times` and `ids` when
    None."""
    obs = np.asarray(obs, np.float64)
    ids = np.asarray(ids)
    if dt is None:
        dt = precompute_dt(times, ids)
    z0, z1 = obs[:-1], obs[1:]
    same_id = (ids[1:] == ids[:-1])[:, None]
    mask = same_id & np.isfinite(z0) & np.isfinite(z1)

    def dev(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return ClosedFormData(
        z0=dev(np.where(mask, z0, 1.0)),
        z1=dev(np.where(mask, z1, 1.0)),
        dt=dev(np.where(same_id[:, 0], np.asarray(dt, np.float64)[:-1], 1.0)),
        mask=torch.as_tensor(mask, device=device),
    )


def closed_form_loglik(type, obs, times, ids, par_mat, other_data=None,
                       dt=None, data: Optional[ClosedFormData] = None):
    """Total log-likelihood for a closed-form transition-density model.

    Args:
      type: one of "BM", "BM_t", "OU", "CIR".
      obs: (n, n_dim) observations, NaN marks missing values.
      times: (n,) observation times.
      ids: (n,) integer track labels (consecutive equal values = one track).
      par_mat: (n, n_par) working-scale parameters (linear predictor rows),
        a tensor; the likelihood is differentiable in it.
      other_data: dict of model extras (e.g. {"df": ...} for BM_t).
      dt: optional precomputed host-f64 intervals (length n, dummy last
        slot, the kalman_soa.precompute_dt convention).
      data: optional prepared per-step data (`prepare_closed_form_data`);
        obs, times, ids and dt are then not read.

    Vectorized equivalent of the loop at nllk_sde.hpp:77-84.
    """
    if data is None:
        if dt is None:
            t = np.asarray(times, np.float64)
            dt = np.concatenate([np.diff(t), np.ones(1)])
        data = prepare_closed_form_data(obs, times, ids, dtype=par_mat.dtype,
                                        device=par_mat.device, dt=dt)
    contrib = CLOSED_FORM_LOGDENS[type](data.z1, data.z0, data.dt,
                                        par_mat[:-1], other_data)
    return torch.sum(torch.where(data.mask, contrib, 0.0))
