"""Small exported utilities mirroring the reference's R/utility.R.

Port of smoothsde_tpu/utils/misc.py (NumPy only). The JAX package's
device-transfer helpers have no counterpart: the port moves data with
an explicit `device` and `dtype` (`to_device` for a fit's small
uploads).
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
import torch


def to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """`a` (array-like) as a tensor of `dtype` on `device`: rounded on the
    host, then copied without a stop. A blocking copy from pageable host
    memory first waits for the device's stream to drain, a stop of the
    host that reads nothing; this one is queued on the stream, and the
    CUDA runtime stages the source before the call returns."""
    t = torch.tensor(np.asarray(a, np.float64), dtype=dtype)
    return t.to(device, non_blocking=True)


def prec_to_cov(prec_mat: np.ndarray) -> np.ndarray:
    """Invert a precision matrix, falling back to the Moore-Penrose
    pseudo-inverse with a warning when singular (utility.R:160-172)."""
    prec = np.asarray(prec_mat, float)
    if not np.all(np.isfinite(prec)):
        warnings.warn(
            "Precision matrix contains non-finite entries (the outer "
            "finite-difference Hessian hit a non-finite region); "
            "affected rows are dropped from the uncertainty estimates.",
            stacklevel=2,
        )
        prec = np.where(np.isfinite(prec), prec, 0.0)
    try:
        cov = np.linalg.solve(prec, np.eye(prec.shape[0]))
        if not np.all(np.isfinite(cov)):
            raise np.linalg.LinAlgError("non-finite inverse")
    except np.linalg.LinAlgError as err:
        warnings.warn(
            f"Inversion of precision matrix failed: {err}. Using the "
            "pseudo-inverse instead (uncertainty estimates may be "
            "unreliable).",
            stacklevel=2,
        )
        cov = np.linalg.pinv(prec)
    return cov


def term_indices(
    names_fe: List[str], names_re: List[str], term: str
) -> Dict[str, np.ndarray]:
    """Indices of coefficients whose names contain `term` as a substring
    (utility.R:137-144; same naive matching, documented as such)."""
    fe = np.array([i for i, nm in enumerate(names_fe) if term in nm], int)
    re = np.array([i for i, nm in enumerate(names_re) if term in nm], int)
    return {"fe": fe, "re": re}


def ctcrw_cov(beta: float, sigma: float, dt: float) -> np.ndarray:
    """Covariance of the joint (velocity, position) CTCRW transition
    (utility.R:188-196; row/col order (V, Z) as there). Uses the
    cancellation-free forms of ops/stable.py."""
    from smoothsde_tpu_torch.ops.stable import ctcrw_transition_terms

    tt = ctcrw_transition_terms(
        np.asarray(beta, float), np.asarray(sigma, float) ** 2,
        np.asarray(dt, float), xp=np,
    )
    return np.array(
        [[tt["q11"], tt["q01"]], [tt["q01"], tt["q00"]]]
    )
