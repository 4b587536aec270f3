"""Helpers shared by the simulators (`sim/<TYPE>.py`)."""

import numpy as np
from scipy.signal import lfilter


def intervals(rng, dt_law, n_paths, steps):
    """(n_paths, steps - 1) intervals drawn by the traffic's law:
    {"law": "fixed", "value": v} or {"law": "uniform", "low": a,
    "high": b}."""
    if dt_law["law"] == "fixed":
        return np.full((n_paths, steps - 1), float(dt_law["value"]))
    if dt_law["law"] == "uniform":
        return rng.uniform(dt_law["low"], dt_law["high"],
                           size=(n_paths, steps - 1))
    raise ValueError(f"unknown dt law {dt_law['law']!r}")


def ar1(rng, coef, sd, x0):
    """x_{k+1} = coef_k x_k + sd_k eps_k from x_0 = x0, eps ~ N(0, 1),
    on the last axis: coef and sd (..., steps - 1), x0 (...,). A
    constant coef runs as one lfilter per leading index."""
    eps = sd * rng.normal(size=coef.shape)
    drive = np.concatenate([x0[..., None], eps], -1)
    if np.all(coef == coef.reshape(-1)[0]):
        return lfilter([1.0], [1.0, -coef.reshape(-1)[0]], drive, axis=-1)
    x = np.empty_like(drive)
    x[..., 0] = x0
    for k in range(coef.shape[-1]):
        x[..., k + 1] = coef[..., k] * x[..., k] + drive[..., k + 1]
    return x
