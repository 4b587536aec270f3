"""Exact simulation of the 2-D (any D) CTCRW with measurement error.

The centred velocity W = V - mu is an AR(1) over each interval, and the
position adds mu dt + W (1 - e) / beta plus the position part of the
step's noise, drawn jointly with the velocity's (Johnson et al. 2008, Ecology):
see `reference/CTCRW.py` for the transition. The velocity starts from its
stationary law, the position at 0.
"""

import math

import numpy as np

from fitbench.sim._paths import ar1, intervals


def simulate(rng, truth, n_paths, steps, dt_law):
    """times (n_paths, steps) and obs (n_paths, steps, D) from `truth`
    {"mu": [..D], "tau", "nu", "sigma_obs"}."""
    mu = np.asarray(truth["mu"], float)
    D = len(mu)
    beta = 1.0 / truth["tau"]
    s2 = 4.0 * truth["nu"] ** 2 / (math.pi * truth["tau"])
    dt = intervals(rng, dt_law, n_paths, steps)
    u = beta * dt
    e = np.exp(-u)
    m1 = -np.expm1(-u)
    q00 = s2 / beta ** 3 * (u - 2.0 * m1 - 0.5 * np.expm1(-2.0 * u))
    q01 = s2 / (2.0 * beta ** 2) * m1 * m1
    q11 = -s2 / (2.0 * beta) * np.expm1(-2.0 * u)
    # the position noise given the velocity noise: regression + residual
    slope = q01 / q11
    resid = np.sqrt(np.maximum(q00 - slope * q01, 0.0))
    obs = np.empty((n_paths, steps, D))
    for d in range(D):
        x0 = rng.normal(size=n_paths) * math.sqrt(s2 / (2.0 * beta))
        w = ar1(rng, e, np.sqrt(q11), x0)
        ev = w[:, 1:] - e * w[:, :-1]  # each step's velocity noise
        dz = (mu[d] * dt + w[:, :-1] * m1 / beta + slope * ev
              + resid * rng.normal(size=dt.shape))
        z = np.concatenate([np.zeros((n_paths, 1)), np.cumsum(dz, 1)], 1)
        obs[:, :, d] = z + truth["sigma_obs"] * rng.normal(size=z.shape)
    times = np.concatenate([np.zeros((n_paths, 1)), np.cumsum(dt, 1)], 1)
    return times, obs
