"""Plain reference of the CTCRW with Gaussian measurement error.

Each dimension's state is (position, velocity), the velocity an
Ornstein-Uhlenbeck process with mean mu, dV = beta (mu - V) dt + sigma
dW, and dZ = V dt, with beta = 1 / tau and sigma = 2 nu / sqrt(pi tau)
(Johnson et al. 2008, Ecology; smoothSDE's CTCRW, Michelot et al.
2021, JABES). Exact transition over dt, u = beta dt, e = exp(-u):
  T = [[1, (1 - e) / beta], [0, e]],
  drift mu (dt - (1 - e) / beta, 1 - e),
  Q00 = sigma^2 / beta^3 (u - 2 (1 - e) + (1 - e^2) / 2),
  Q01 = sigma^2 / (2 beta^2) (1 - e)^2,
  Q11 = sigma^2 / (2 beta) (1 - e^2).
A track starts at a0 = (its first observation, 0) with P0 = diag(1, 10).
The coefficient vector is (mu_1 .. mu_D, log tau, log nu).
"""

import math

import torch

from fitbench.reference._filter import ssm_names as names  # noqa: F401
from fitbench.reference._filter import ssm_start as start  # noqa: F401
from fitbench.reference._filter import ssm_truth as truth  # noqa: F401
from fitbench.reference._filter import ssm_nllk

STATE = 2


def system(coeff, obs, dt):
    """(T, u, Q, a0, P0) for `reference/_filter.nllk`: obs (n, B, D),
    dt (n, B), coeff (D + 2,), all of one dtype and device."""
    D = obs.shape[-1]
    mu = coeff[:D]
    tau = torch.exp(coeff[D])
    nu = torch.exp(coeff[D + 1])
    beta = 1.0 / tau
    s2 = 4.0 * nu * nu / (math.pi * tau)
    u = beta * dt
    e = torch.exp(-u)
    m1 = -torch.expm1(-u)  # 1 - e
    zero, one = torch.zeros_like(e), torch.ones_like(e)
    T = torch.stack([torch.stack([one, m1 / beta], -1),
                     torch.stack([zero, e], -1)], -2)
    q00 = s2 / beta ** 3 * (u - 2.0 * m1 - 0.5 * torch.expm1(-2.0 * u))
    q01 = s2 / (2.0 * beta ** 2) * m1 * m1
    q11 = -s2 / (2.0 * beta) * torch.expm1(-2.0 * u)
    Q = torch.stack([torch.stack([q00, q01], -1),
                     torch.stack([q01, q11], -1)], -2)
    drift = torch.stack([dt - m1 / beta, m1], -1)  # (n, B, 2)
    uvec = mu[:, None] * drift[:, :, None, :]  # (n, B, D, 2)
    a0 = torch.stack([obs[0], torch.zeros_like(obs[0])], -1)
    P0 = torch.diag(torch.tensor([1.0, 10.0], dtype=obs.dtype,
                                 device=obs.device))
    return T[:, :, None], uvec, Q[:, :, None], a0, P0


def nllk(config, theta, obs, dt, dtype):
    """The nllk at the outer vector theta (log sigma_obs, then the
    coefficients), the filter in `dtype`."""
    return ssm_nllk(system, theta, obs, dt, dtype)
