"""Per-dimension step builders for the state-space (Kalman) models.

Port of the per-dim builders of smoothsde_tpu/models/ssm.py
(`ctcrw_steps_perdim`, `diag_ssm_steps_perdim`, and the helpers they
share). Each maps working-scale parameter rows to stacked per-step
(T, b, Q, Z, H) tensors with a leading dimension axis for the
sequential filter of ops/kalman.py, which the Laplace layer's
forward-mode twin of the likelihood runs on the CPU (infer/objective.py
`loglik_ad`). With isotropic observation noise the filter factorizes
exactly across response dims (the dynamics are block-diagonal per dim,
and the missing-row rule reads the first response only): d independent
small-state sequences, every matrix op in closed form. This replaces
the reference's makeT/makeQ/makeB/makeH template families
(nllk_ctcrw.hpp:26-91, nllk_bm_ssm.hpp:11-36, nllk_ou_ssm.hpp:11-69).
The full-state builders, user H / P0 and ESEAL_SSM wait for the generic
filter (ROADMAP queue 1 item 5).

Conventions shared with the reference:
  - dt_i = t_{i+1} - t_i, with dt = 1 at each track's last step (the
    clock may restart across tracks) and at the dummy last slot;
  - (T_i, b_i, Q_i) propagate from observation i to i + 1 and are built
    from parameter row i;
  - a0 per track: the first observation (SSMs), (x1, 0) per dim for
    CTCRW (R/sde.R:547-580); P0 10 (SSMs, R/sde.R:554) and diag(1, 10)
    per dim for CTCRW (R/sde.R:584);
  - a missing observation is a row whose FIRST response is NaN
    (nllk_ctcrw.hpp:214).

obs, times and ids may be NumPy arrays or tensors; `dt` (the host f64
intervals of ops/kalman_soa.precompute_dt, on the device) skips the
differencing. The BM_SSM / OU_SSM transition is ops/diag_fused.py's
`diag_transition`, the one the kernel path takes (OU from the stable
`ou_transition_terms`: ROADMAP queue 3, "Intended differences").
"""

from __future__ import annotations

import math

import torch

from smoothsde_tpu_torch.ops.diag_fused import P0 as SSM_P0
from smoothsde_tpu_torch.ops.diag_fused import diag_transition
from smoothsde_tpu_torch.ops.kalman import KalmanSteps
from smoothsde_tpu_torch.ops.stable import ctcrw_transition_terms


def _dt_from_times(times, ids=None):
    """Per-step dt with dt_{n-1} = 1 (the reference's dummy) and the
    cross-track intervals replaced by 1 (a restarted clock gives a
    negative diff, and exp(-beta dt) then overflows in f32)."""
    dt = torch.diff(times)
    if ids is not None:
        same = ids[1:] == ids[:-1]
        dt = torch.where(same, dt, 1.0)
    return torch.cat([dt, dt.new_ones(1)])


def _reset_mask(ids):
    return torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                      ids[1:] != ids[:-1]])


def _common(obs, times, ids, dt=None, *, dtype, device):
    """(dt, reset, valid, y) on `device`: y is obs with NaN -> 0."""
    obs = torch.as_tensor(obs, device=device).to(dtype)
    ids = torch.as_tensor(ids, device=device)
    if dt is None:
        dt = _dt_from_times(torch.as_tensor(times, device=device).to(dtype),
                            ids)
    else:
        dt = torch.as_tensor(dt, device=device).to(dtype)
    reset = _reset_mask(ids)
    valid = torch.isfinite(obs[:, 0])
    y = torch.nan_to_num(obs, nan=0.0)
    return dt, reset, valid, y


def _ctcrw_blocks(par_mat, dt, n_dim):
    """The per-step 2x2 transition and noise blocks (n, 2, 2) and the
    drift factors (n, 2) of the velocity OU: beta = 1/tau, sigma = 2 nu /
    sqrt(pi tau) (nllk_ctcrw.hpp:46-91, 150-156)."""
    tau = torch.exp(par_mat[:, n_dim])
    nu = torch.exp(par_mat[:, n_dim + 1])
    beta = 1.0 / tau
    sigma2 = 4.0 * nu * nu / (math.pi * tau)
    tt = ctcrw_transition_terms(beta, sigma2, dt)
    e1 = tt["e1"]
    T2 = torch.stack([torch.stack([torch.ones_like(e1), tt["g"]], dim=-1),
                      torch.stack([torch.zeros_like(e1), e1], dim=-1)],
                     dim=-2)
    Q2 = torch.stack([torch.stack([tt["q00"], tt["q01"]], dim=-1),
                      torch.stack([tt["q01"], tt["q11"]], dim=-1)], dim=-2)
    return T2, Q2, torch.stack([tt["bp"], tt["bv"]], dim=-1)


def ctcrw_steps_perdim(par_mat, obs, times, ids, sigma_obs,
                       dt=None) -> KalmanSteps:
    """CTCRW steps with a leading dimension axis: leaves (n_dim, n, ...),
    per-dim state (position, velocity)."""
    dtype, device = par_mat.dtype, par_mat.device
    dt, reset, valid, y = _common(obs, times, ids, dt, dtype=dtype,
                                  device=device)
    n, n_dim = y.shape
    mu = par_mat[:, :n_dim]
    T2, Q2, bd = _ctcrw_blocks(par_mat, dt, n_dim)
    T = T2.expand(n_dim, n, 2, 2)
    Q = Q2.expand(n_dim, n, 2, 2)
    b = mu.T[:, :, None] * bd[None]  # (d, n, 2)
    Z = torch.tensor([[1.0, 0.0]], dtype=dtype,
                     device=device).expand(n_dim, n, 1, 2)
    H = (sigma_obs**2) * torch.ones((n_dim, n, 1, 1), dtype=dtype,
                                    device=device)
    yd = y.T[:, :, None]  # (d, n, 1)
    a0 = torch.where(reset[None, :], y.T, 0.0)
    a0 = torch.stack([a0, torch.zeros_like(a0)], dim=-1)  # (d, n, 2)
    P0 = torch.tensor([[1.0, 0.0], [0.0, 10.0]], dtype=dtype,
                      device=device).expand(n_dim, n, 2, 2)
    resets = reset.expand(n_dim, n)
    valids = valid.expand(n_dim, n)
    return KalmanSteps(T, b, Q, Z, H, yd, a0, P0, resets, valids)


def diag_ssm_steps_perdim(type, par_mat, obs, times, ids, sigma_obs,
                          dt=None) -> KalmanSteps:
    """BM_SSM / OU_SSM with a leading dimension axis and a scalar state:
    every matrix is (.., 1, 1)."""
    dtype, device = par_mat.dtype, par_mat.device
    dt, reset, valid, y = _common(obs, times, ids, dt, dtype=dtype,
                                  device=device)
    n, n_dim = y.shape
    t_s, q_s, b_s = diag_transition(type, par_mat, dt, n_dim)
    T = t_s[:, None, None].expand(n_dim, n, 1, 1)
    Q = q_s[:, None, None].expand(n_dim, n, 1, 1)
    b = b_s[:, :, None]
    Z = torch.ones((n_dim, n, 1, 1), dtype=dtype, device=device)
    H = (sigma_obs**2) * Z
    yd = y.T[:, :, None]
    a0 = torch.where(reset[None, :], y.T, 0.0)[:, :, None]
    P0 = torch.full((n_dim, n, 1, 1), SSM_P0, dtype=dtype, device=device)
    resets = reset.expand(n_dim, n)
    valids = valid.expand(n_dim, n)
    return KalmanSteps(T, b, Q, Z, H, yd, a0, P0, resets, valids)
