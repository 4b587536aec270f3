"""Exact simulation of the OU_SSM: each dimension an Ornstein-Uhlenbeck
process with mean mu, time scale tau and stationary variance kappa,
started from its stationary law, observed with Gaussian error (see
`reference/OU_SSM.py` for the transition)."""

import math

import numpy as np

from fitbench.sim._paths import ar1, intervals


def simulate(rng, truth, n_paths, steps, dt_law):
    """times (n_paths, steps) and obs (n_paths, steps, D) from `truth`
    {"mu": [..D], "tau", "kappa", "sigma_obs"}."""
    mu = np.asarray(truth["mu"], float)
    dt = intervals(rng, dt_law, n_paths, steps)
    e = np.exp(-dt / truth["tau"])
    sd = np.sqrt(-truth["kappa"] * np.expm1(-2.0 * dt / truth["tau"]))
    obs = np.empty((n_paths, steps, len(mu)))
    for d, m in enumerate(mu):
        x0 = rng.normal(size=n_paths) * math.sqrt(truth["kappa"])
        x = m + ar1(rng, e, sd, x0)
        obs[:, :, d] = x + truth["sigma_obs"] * rng.normal(size=x.shape)
    times = np.concatenate([np.zeros((n_paths, 1)), np.cumsum(dt, 1)], 1)
    return times, obs
