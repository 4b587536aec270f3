"""Per-step system-matrix builders for the state-space (Kalman) models.

Port of smoothsde_tpu/models/ssm.py. Each builder maps working-scale
parameter rows to stacked per-step (T, b, Q, Z, H) tensors for the
filters of ops/kalman.py, replacing the reference's makeT/makeQ/makeB/
makeH template families (nllk_ctcrw.hpp:26-91, nllk_bm_ssm.hpp:11-36,
nllk_ou_ssm.hpp:11-69, nllk_e_seal_ssm.hpp:11-59):

  - the full-state builders `bm_ssm_steps`, `ou_ssm_steps`,
    `ctcrw_steps` (with a user observation covariance `H_array` (n, m, m)
    and initial covariance `P0`) and `eseal_ssm_steps`
    (`SSM_STEP_BUILDERS`): the generic filter's input, and what the
    filtered states and innovations of every state-space type are read
    from;
  - the per-dim builders `ctcrw_steps_perdim`, `diag_ssm_steps_perdim`:
    with isotropic observation noise the filter factorizes exactly
    across response dims (the dynamics are block-diagonal per dim, and
    the missing-row rule reads the first response only): d independent
    small-state sequences, every matrix op in closed form. The Laplace
    layer's forward-mode twin runs them on the CPU (infer/objective.py
    `loglik_ad`).

Conventions shared with the reference:
  - dt_i = t_{i+1} - t_i, with dt = 1 at each track's last step (the
    clock may restart across tracks) and at the dummy last slot;
  - (T_i, b_i, Q_i) propagate from observation i to i + 1 and are built
    from parameter row i;
  - a0 per track: the first observation (SSMs), (x1, 0) per dim for
    CTCRW (R/sde.R:547-580), (1, the track start's dep_fat) for ESEAL
    (R/sde.R:602); P0 10 I (SSMs, R/sde.R:554), diag(1, 10) per dim for
    CTCRW (R/sde.R:584), diag(0, 10) for ESEAL (R/sde.R:603);
  - a missing observation is a row whose FIRST response is NaN
    (nllk_ctcrw.hpp:214).

obs, times, ids, H_array, P0 and ESEAL's h, R, dep_fat may be NumPy
arrays or tensors; `dt` (the host f64 intervals of
ops/kalman_soa.precompute_dt, on the device) skips the differencing.
The BM_SSM / OU_SSM transition is ops/diag_fused.py's
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


def _scatter_track_starts(values_at_starts, reset):
    """Per-track initial states at the reset rows, zeros elsewhere."""
    return torch.where(reset[:, None], values_at_starts, 0.0)


def _as(x, like):
    """x as a tensor of like's dtype and device."""
    return torch.as_tensor(x, device=like.device).to(like.dtype)


def _obs_noise(n, n_dim, sigma_obs, H_array, like):
    """Per-step observation covariance: the user's H_array (R/sde.R:
    563-568) or sigma_obs^2 I."""
    if H_array is not None:
        return _as(H_array, like)
    eye = torch.eye(n_dim, dtype=like.dtype, device=like.device)
    return (sigma_obs**2 * eye).expand(n, n_dim, n_dim)


def _initial_cov(P0, default, n, like):
    """P0 (the user's, else `default`) broadcast to (n, s, s)."""
    P0 = _as(default if P0 is None else P0, like)
    return P0.expand(n, *P0.shape[-2:])


def _scalar_state_steps(t_s, q_s, b_s, y, reset, valid, sigma_obs, H_array,
                        P0, like) -> KalmanSteps:
    """Full-state steps of BM_SSM / OU_SSM: T = t I, b, Q = q I, Z = I,
    a0 the track's first observation (R/sde.R:547-550), P0 10 I."""
    n, n_dim = y.shape
    eye = torch.eye(n_dim, dtype=like.dtype, device=like.device)
    T = t_s[:, None, None] * eye
    Q = q_s[:, None, None] * eye
    Z = eye.expand(n, n_dim, n_dim)
    H = _obs_noise(n, n_dim, sigma_obs, H_array, like)
    a0 = _scatter_track_starts(y, reset)
    P0 = _initial_cov(P0, SSM_P0 * eye, n, like)
    return KalmanSteps(T, b_s, Q, Z, H, y, a0, P0, reset, valid)


def bm_ssm_steps(par_mat, obs, times, ids, sigma_obs, H_array=None, P0=None,
                 dt=None) -> KalmanSteps:
    """BM + iid Gaussian measurement error; state = latent position:
    T = I, b = mu dt, Q = sigma^2 dt I (nllk_bm_ssm.hpp:29-36,138-139)."""
    dt, reset, valid, y = _common(obs, times, ids, dt, dtype=par_mat.dtype,
                                  device=par_mat.device)
    t_s, q_s, b_s = diag_transition("BM_SSM", par_mat, dt, y.shape[1])
    return _scalar_state_steps(t_s, q_s, b_s.T, y, reset, valid, sigma_obs,
                               H_array, P0, par_mat)


def ou_ssm_steps(par_mat, obs, times, ids, sigma_obs, H_array=None, P0=None,
                 dt=None) -> KalmanSteps:
    """OU + measurement error: T = e^{-dt/tau} I, b = (1 - e^{-dt/tau})
    mu, Q = kappa (1 - e^{-2 dt/tau}) I (nllk_ou_ssm.hpp:31-69,174-177),
    from the stable `ou_transition_terms`."""
    dt, reset, valid, y = _common(obs, times, ids, dt, dtype=par_mat.dtype,
                                  device=par_mat.device)
    t_s, q_s, b_s = diag_transition("OU_SSM", par_mat, dt, y.shape[1])
    return _scalar_state_steps(t_s, q_s, b_s.T, y, reset, valid, sigma_obs,
                               H_array, P0, par_mat)


def ctcrw_steps(par_mat, obs, times, ids, sigma_obs, H_array=None, P0=None,
                dt=None) -> KalmanSteps:
    """CTCRW (integrated OU); state (pos_1, vel_1, pos_2, vel_2, ...), the
    reference layout, with the per-dim 2x2 blocks of `_ctcrw_blocks` on
    the diagonal; Z picks the positions."""
    dtype, device = par_mat.dtype, par_mat.device
    dt, reset, valid, y = _common(obs, times, ids, dt, dtype=dtype,
                                  device=device)
    n, n_dim = y.shape
    T2, Q2, bd = _ctcrw_blocks(par_mat, dt, n_dim)
    blocks = torch.eye(n_dim, dtype=dtype, device=device)[:, None, :, None]
    # (n, d, 2, d, 2) -> (n, 2d, 2d): block (i, j) is T2 where i == j
    T = (T2[:, None, :, None, :] * blocks).reshape(n, 2 * n_dim, 2 * n_dim)
    Q = (Q2[:, None, :, None, :] * blocks).reshape(n, 2 * n_dim, 2 * n_dim)
    mu = par_mat[:, :n_dim]
    b = (mu[:, :, None] * bd[:, None, :]).reshape(n, 2 * n_dim)
    Z = torch.eye(2 * n_dim, dtype=dtype, device=device)[::2].expand(
        n, n_dim, 2 * n_dim)
    H = _obs_noise(n, n_dim, sigma_obs, H_array, par_mat)
    # a0 = (x1, 0, y1, 0, ...) per track (R/sde.R:576-580)
    a0 = _scatter_track_starts(
        torch.stack([y, torch.zeros_like(y)], dim=-1).reshape(n, 2 * n_dim),
        reset)
    vel = (torch.arange(2 * n_dim, device=device) % 2).to(dtype)
    P0 = _initial_cov(P0, torch.diag(1.0 + 9.0 * vel), n, par_mat)
    return KalmanSteps(T, b, Q, Z, H, y, a0, P0, reset, valid)


def eseal_ssm_steps(par_mat, obs, times, ids, log_tau, a1, log_a2, h, R,
                    dep_fat, P0=None, dt=None) -> KalmanSteps:
    """Elephant-seal body-condition SSM; state (intercept, lipid mass):
    T = [[1, 0], [mu dt, 1]], Q = diag(0, sigma^2 dt), Z = [a1, a2/R_i],
    H = tau^2/h_i (nllk_e_seal_ssm.hpp:11-59,170-174)."""
    dtype, device = par_mat.dtype, par_mat.device
    dt, reset, valid, y = _common(obs, times, ids, dt, dtype=dtype,
                                  device=device)
    mu, sigma = par_mat[:, 0], torch.exp(par_mat[:, 1])
    zero, one = torch.zeros_like(mu), torch.ones_like(mu)
    T = torch.stack([torch.stack([one, zero], -1),
                     torch.stack([mu * dt, one], -1)], -2)
    Q = torch.stack([torch.stack([zero, zero], -1),
                     torch.stack([zero, sigma**2 * dt], -1)], -2)
    b = torch.zeros((len(mu), 2), dtype=dtype, device=device)
    R, h = _as(R, par_mat), _as(h, par_mat)
    Z = torch.stack([a1 * one, torch.exp(_as(log_a2, par_mat)) / R],
                    -1)[:, None, :]
    H = (torch.exp(_as(log_tau, par_mat)) ** 2 / h)[:, None, None]
    a0 = _scatter_track_starts(torch.stack([one, _as(dep_fat, par_mat)], -1),
                               reset)
    P0 = _initial_cov(P0, torch.diag(10.0 * torch.arange(
        2, dtype=dtype, device=device)), len(mu), par_mat)
    return KalmanSteps(T, b, Q, Z, H, y, a0, P0, reset, valid)


SSM_STEP_BUILDERS = {
    "BM_SSM": bm_ssm_steps,
    "OU_SSM": ou_ssm_steps,
    "CTCRW": ctcrw_steps,
    "ESEAL_SSM": eseal_ssm_steps,
}


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


def ctcrw_steps_perdim(par_mat, obs, times, ids, sigma_obs, P0=None,
                       dt=None) -> KalmanSteps:
    """CTCRW steps with a leading dimension axis: leaves (n_dim, n, ...),
    per-dim state (position, velocity). P0 (2d, 2d) gives each dim its
    diagonal 2x2 block."""
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
    if P0 is None:
        P0 = torch.tensor([[1.0, 0.0], [0.0, 10.0]], dtype=dtype,
                          device=device).expand(n_dim, n, 2, 2)
    else:
        P0 = _as(P0, par_mat)
        P0 = torch.stack([P0[2 * k:2 * k + 2, 2 * k:2 * k + 2]
                          for k in range(n_dim)])[:, None].expand(
                              n_dim, n, 2, 2)
    resets = reset.expand(n_dim, n)
    valids = valid.expand(n_dim, n)
    return KalmanSteps(T, b, Q, Z, H, yd, a0, P0, resets, valids)


def diag_ssm_steps_perdim(type, par_mat, obs, times, ids, sigma_obs,
                          P0=None, dt=None) -> KalmanSteps:
    """BM_SSM / OU_SSM with a leading dimension axis and a scalar state:
    every matrix is (.., 1, 1); P0 (d, d) gives each dim its diagonal
    entry."""
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
    if P0 is None:
        P0 = torch.full((n_dim, n, 1, 1), SSM_P0, dtype=dtype, device=device)
    else:
        P0 = torch.diagonal(_as(P0, par_mat))[:, None, None, None].expand(
            n_dim, n, 1, 1)
    resets = reset.expand(n_dim, n)
    valids = valid.expand(n_dim, n)
    return KalmanSteps(T, b, Q, Z, H, yd, a0, P0, resets, valids)
