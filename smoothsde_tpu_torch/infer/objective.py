"""Joint negative log-likelihood assembly for the ported state-space
models.

Port of smoothsde_tpu/infer/objective.py (build_objective, the isotropic
state-space branch, objective.py:556-571 of the JAX package):

    nllk(params) = -loglik(par_matrix(params))

with par_matrix the (n, n_par) working-scale linear predictor built from
the fixed-effect design blocks, and loglik the Kalman filter on the fused
kernels: CTCRW through ops/kalman_soa.ctcrw_loglik_soa (scan="fused",
analytic_grad=True, as the JAX package's CTCRW branch), BM_SSM / OU_SSM
through ops/diag_fused.diag_ssm_loglik_fused. The slice is these models
with formulas of intercepts and linear/factor terms, no random effects
or smooths, no user H or P0, no mesh; everything else raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from smoothsde_tpu_torch.infer.params import ParamBlock, ParamPacker
from smoothsde_tpu_torch.models.registry import ModelSpec
from smoothsde_tpu_torch.ops.diag_fused import (
    diag_ssm_loglik_fused,
    prepare_diag_data,
)
from smoothsde_tpu_torch.ops.kalman_soa import (
    ctcrw_loglik_soa,
    prepare_ctcrw_data,
)

PORTED_TYPES = ("CTCRW", "BM_SSM", "OU_SSM")

_ROADMAP = {
    "random_effects": "queue 1 item 7 (Laplace and random effects)",
    "closed_form": "queue 1 item 8b (closed-form family BM/BM_t/OU/CIR)",
    "generic": "queue 1 item 8c (generic filters: user H/P0, ESEAL_SSM)",
}


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is outside the ported slice ({', '.join(PORTED_TYPES)}); "
        f"see ROADMAP.md {_ROADMAP[item]}"
    )


def check_slice(spec: ModelSpec, design=None, other_data=None):
    """Raise NotImplementedError for anything outside the ported slice."""
    if spec.kind == "closed_form":
        raise _unported(f"model type {spec.type!r}", "closed_form")
    if spec.type not in PORTED_TYPES:
        raise _unported(f"model type {spec.type!r}", "generic")
    other_data = other_data or {}
    for key in ("H", "P0"):
        if other_data.get(key) is not None:
            raise _unported(f"other_data[{key!r}]", "generic")
    if design is not None and sum(design.ncol_re) > 0:
        raise _unported("smooth / random-effect terms", "random_effects")


def resolve_device(device) -> torch.device:
    """The working device, exactly as asked: a CUDA request without a
    card raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return device


@dataclasses.dataclass
class ObjectiveBundle:
    """Everything the fitting layer needs."""

    joint_nllk: Callable  # fn(full_params_dict) -> 0-d tensor
    packer: ParamPacker
    par_matrix: Callable  # fn(full_params_dict) -> (n, n_par) working scale
    n_obs: int
    dtype: torch.dtype
    device: torch.device


def build_objective(
    spec: ModelSpec,
    design,  # DesignMatrices
    obs: np.ndarray,
    times: np.ndarray,
    ids: np.ndarray,
    other_data: Optional[dict] = None,
    fixpar: Optional[List[str]] = None,
    init: Optional[Dict[str, np.ndarray]] = None,
    map_fix: Optional[Dict[str, np.ndarray]] = None,
    *,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> ObjectiveBundle:
    other_data = dict(other_data or {})
    fixpar = list(fixpar or [])
    init = dict(init or {})
    map_fix = dict(map_fix or {})
    check_slice(spec, design, other_data)
    device = resolve_device(device)
    n, n_dim = obs.shape
    param_names = list(spec.param_names)
    n_par = len(param_names)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=device, dtype=dtype
        )

    # Constant-column FE blocks (intercept-only formulas) collapse to a
    # broadcast of a length-p dot product instead of an (n, p) matvec.
    fe_const_rows = [
        dev(X[0]) if X.shape[0] > 0 and np.all(np.ptp(X, axis=0) == 0)
        else None
        for X in design.fe_blocks()
    ]
    fe_blocks = [
        None if fe_const_rows[j] is not None else dev(X)
        for j, X in enumerate(design.fe_blocks())
    ]
    fe_off = np.concatenate([[0], np.cumsum(design.ncol_fe)]).astype(int)
    p_fe = int(fe_off[-1])

    # the per-step data (observations, f64-derived intervals, masks) is
    # built once on the device, not per evaluation
    if spec.type == "CTCRW":
        data = prepare_ctcrw_data(obs, times, ids, dtype=dtype, device=device)
    else:
        data = prepare_diag_data(spec.type, obs, times, ids, dtype=dtype,
                                 device=device)

    # ---- parameter blocks (same names and order as the JAX package) ----
    def _init(name, size, default=0.0):
        v = np.asarray(init.get(name, np.full(size, default)), float)
        v = v.reshape(-1)
        if v.size != size:
            raise ValueError(f"init for {name!r} has wrong size")
        return v

    fixed_sobs = np.array([False])
    if "log_sigma_obs" in map_fix:
        fixed_sobs = np.atleast_1d(np.asarray(map_fix["log_sigma_obs"], bool))
    # Data-driven default: sigma_obs ~ a fraction of the median step
    # length, which keeps BFGS's first line search off the tau -> inf
    # plateau when the true noise is far below 1 (objective.py:270-292
    # of the JAX package).
    step_med = float(
        np.nanmedian(np.abs(np.diff(np.asarray(obs, float), axis=0)))
    )
    default_ls = (
        float(np.log(0.3 * step_med))
        if np.isfinite(step_med) and step_med > 0
        else 0.0
    )
    blocks = [
        ParamBlock("log_sigma_obs", _init("log_sigma_obs", 1, default_ls),
                   fixed_sobs),
    ]
    cfe_fixed = np.zeros(p_fe, bool)
    for j, pname in enumerate(param_names):
        if pname in fixpar:
            cfe_fixed[fe_off[j] : fe_off[j + 1]] = True
    if "coeff_fe" in map_fix:
        cfe_fixed = cfe_fixed | np.asarray(map_fix["coeff_fe"], bool)
    blocks.append(ParamBlock("coeff_fe", _init("coeff_fe", p_fe), cfe_fixed))
    # no smooths in the slice: log_lambda and coeff_re are fixed stubs
    blocks.append(ParamBlock("log_lambda", _init("log_lambda", 1),
                             np.ones(1, bool)))
    blocks.append(ParamBlock("coeff_re", _init("coeff_re", 1),
                             np.ones(1, bool)))
    packer = ParamPacker(blocks, inner="coeff_re")

    def par_matrix(full):
        cfe = full["coeff_fe"]
        cols = []
        for j in range(n_par):
            cfe_j = cfe[fe_off[j] : fe_off[j + 1]]
            if fe_const_rows[j] is not None:
                cols.append((fe_const_rows[j] @ cfe_j).expand(n))
            else:
                cols.append(fe_blocks[j] @ cfe_j)
        return torch.stack(cols, dim=1)

    def joint_nllk(full):
        sobs = torch.exp(full["log_sigma_obs"][0])
        if spec.type == "CTCRW":
            return -ctcrw_loglik_soa(
                par_matrix(full), None, None, None, sigma_obs=sobs,
                scan="fused", analytic_grad=True, data=data,
            )
        return -diag_ssm_loglik_fused(
            spec.type, par_matrix(full), None, None, None, sigma_obs=sobs,
            data=data,
        )

    return ObjectiveBundle(
        joint_nllk=joint_nllk,
        packer=packer,
        par_matrix=par_matrix,
        n_obs=n,
        dtype=dtype,
        device=device,
    )
