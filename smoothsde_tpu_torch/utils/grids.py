"""Covariate grids for parameter plots/predictions
(mirrors the reference R/utility.R:43-98).

Port of smoothsde_tpu/utils/grids.py (NumPy only)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from smoothsde_tpu_torch.formula.design import ColumnData


def cov_grid(
    var: str,
    data: ColumnData,
    var_names: List[str],
    covs: Optional[dict] = None,
    n_grid: int = 1000,
) -> Dict[str, np.ndarray]:
    """Grid over `var` with other covariates at their mean (numeric) or
    first level (factor), unless pinned via `covs`."""
    covs = dict(covs or {})
    if var not in var_names:
        var_names = list(var_names) + [var]
    out: Dict[str, np.ndarray] = {}

    if var in data and data.is_factor(var):
        grid = np.asarray(data.levels(var))
    else:
        x = data.numeric(var)
        grid = np.linspace(np.nanmin(x), np.nanmax(x), n_grid)
    n = len(grid)
    out[var] = grid

    for name in var_names:
        if name == var or name == "pi":
            continue
        if name in covs:
            val = covs[name]
            out[name] = np.full(n, val)
        elif data.is_factor(name):
            out[name] = np.full(n, data.levels(name)[0], dtype=object)
        else:
            out[name] = np.full(n, float(np.nanmean(data.numeric(name))))
    return out
