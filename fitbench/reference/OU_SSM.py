"""Plain reference of the OU_SSM: an Ornstein-Uhlenbeck process with
Gaussian measurement error.

Each dimension's state is the process, dX = beta (mu - X) dt + sigma dW,
with tau = 1 / beta and kappa = sigma^2 / (2 beta) its stationary
variance (smoothSDE's OU_SSM). Exact transition over dt, e = exp(-dt /
tau): T = e, drift mu (1 - e), Q = kappa (1 - e^2). A track starts at
a0 = its first observation with P0 = 10. The coefficient vector is
(mu_1 .. mu_D, log tau, log kappa).
"""

import torch

from fitbench.reference._filter import ssm_names as names  # noqa: F401
from fitbench.reference._filter import ssm_start as start  # noqa: F401
from fitbench.reference._filter import ssm_truth as truth  # noqa: F401
from fitbench.reference._filter import ssm_nllk

STATE = 1


def system(coeff, obs, dt):
    """(T, u, Q, a0, P0) for `reference/_filter.nllk`: obs (n, B, D),
    dt (n, B), coeff (D + 2,), all of one dtype and device."""
    D = obs.shape[-1]
    mu = coeff[:D]
    tau = torch.exp(coeff[D])
    kappa = torch.exp(coeff[D + 1])
    u = dt / tau
    T = torch.exp(-u)[..., None, None, None]  # (n, B, 1, 1, 1)
    Q = (-kappa * torch.expm1(-2.0 * u))[..., None, None, None]
    uvec = (mu * -torch.expm1(-u)[..., None])[..., None]  # (n, B, D, 1)
    a0 = obs[0][..., None]
    P0 = torch.full((1, 1), 10.0, dtype=obs.dtype, device=obs.device)
    return T, uvec, Q, a0, P0


def nllk(config, theta, obs, dt, dtype):
    """The nllk at the outer vector theta (log sigma_obs, then the
    coefficients), the filter in `dtype`."""
    return ssm_nllk(system, theta, obs, dt, dtype)
