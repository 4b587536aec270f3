"""Penalized joint negative log-likelihood assembly.

Port of smoothsde_tpu/infer/objective.py (build_objective):

    nllk(params) = -loglik(par_matrix(params)) + penalty(coeff_re, lambda)

with par_matrix the (n, n_par) working-scale linear predictor
(X_fe coeff_fe + X_re coeff_re, per-parameter blocks, the random-effect
columns optionally decay-modulated), and loglik one of:
  - the closed-form models BM, BM_t, OU, CIR: the transition-density sum
    of ops/densities.py (objective.py:414-424 of the JAX package), plain
    torch ops, so torch.func transforms it to any order and the Laplace
    approximation (infer/laplace.py) integrates smooths and random
    effects out;
  - the isotropic state-space models on the fused kernels: CTCRW through
    ops/kalman_soa.ctcrw_loglik_soa (scan="fused", analytic_grad=True),
    BM_SSM / OU_SSM through ops/diag_fused.diag_ssm_loglik_fused
    (objective.py:556-571). Their gradients are reverse-only
    autograd.Functions, so each also has `loglik_ad`, a mathematically
    identical twin in plain tensor arithmetic (objective.py:584-630)
    that carries every second-order quantity of the Laplace layer
    (`joint_nllk_ad`) and the joint precision (`joint_nllk_ad_flat`).
    The twin reaches no kernel. Its route (`twin_route`, a function of
    the device and n): on the CPU the per-dim sequential filter batched
    by track (ops/kalman.py, the JAX package's CPU route); on a CUDA
    device the SoA filter with a plain scan, "blocked" from
    TWIN_SOA_MIN_STEPS steps and "associative" below (PERF.md §5).

`kalman_impl` picks the state-space value route: "auto" and "soa" the
fused kernels (their plain versions on the CPU), "sequential" the
per-dim sequential filter (ops/kalman.py, objective.py:572-582 of the
JAX package); "parallel" and "sqrt" wait for ROADMAP.md queue 1 item 5.
The bundle's `loglik` is that route's unpenalized log-likelihood: under
torch.no_grad on a CUDA model a value-only pass through the forward
kernels (K1a, K2, K1b for CTCRW; D1a, K2, D1b for BM_SSM / OU_SSM).

With random effects and no REML or pinned entries, p_re >= 16 inner
coefficients get a colored Hessian plan (infer/coloring.py). Everything
outside this (user H or P0; ESEAL_SSM; a mesh) raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from smoothsde_tpu_torch.infer.params import ParamBlock, ParamPacker
from smoothsde_tpu_torch.models.registry import ModelSpec
from smoothsde_tpu_torch.models.ssm import (
    ctcrw_steps_perdim,
    diag_ssm_steps_perdim,
)
from smoothsde_tpu_torch.ops.densities import (
    closed_form_loglik,
    prepare_closed_form_data,
)
from smoothsde_tpu_torch.ops.diag_fused import (
    diag_ssm_loglik_fused,
    prepare_diag_data,
)
from smoothsde_tpu_torch.ops.kalman import (
    batch_steps_by_track,
    kalman_loglik_batched,
    track_pad_plan,
)
from smoothsde_tpu_torch.ops.kalman_soa import (
    ctcrw_loglik_soa,
    diag_ssm_loglik_soa,
    precompute_dt,
    prepare_ctcrw_data,
)
from smoothsde_tpu_torch.ops.penalty import make_penalty

CLOSED_FORM_TYPES = ("BM", "BM_t", "OU", "CIR")
SSM_TYPES = ("CTCRW", "BM_SSM", "OU_SSM")
PORTED_TYPES = CLOSED_FORM_TYPES + SSM_TYPES

_ROADMAP = {
    "generic": "queue 1 item 5 (generic and special filters: user H/P0, "
               "ESEAL_SSM)",
    "sharding": "queue 1 item 6 (sharding)",
}

# setup(kalman_impl=...) choices: "auto" runs the fused kernels,
# "sequential" the per-dim sequential filter; "soa" is the JAX package's
# name for the route "auto" takes here; the rest are not ported
KALMAN_IMPLS = ("auto", "sequential")
IMPL_ALIASES = {"soa": "auto"}
UNPORTED_IMPLS = ("parallel", "sqrt")


def unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is outside the ported slice ({', '.join(PORTED_TYPES)}); "
        f"see ROADMAP.md {_ROADMAP[item]}"
    )


def check_slice(spec: ModelSpec, other_data=None):
    """Raise NotImplementedError for anything outside the ported slice."""
    if spec.type not in PORTED_TYPES:
        raise unported(f"model type {spec.type!r}", "generic")
    if spec.kind == "closed_form":
        return
    other_data = other_data or {}
    for key in ("H", "P0"):
        if other_data.get(key) is not None:
            raise unported(f"other_data[{key!r}]", "generic")


# The forward-mode twin's route on a CUDA device: the SoA filter's
# "blocked" plain scan from this many steps, its "associative" scan
# below (PERF.md §5 has both forms' times on the H100).
TWIN_SOA_MIN_STEPS = 65536


def twin_route(device: torch.device, n: int) -> str:
    """The twin's route for n steps on `device`: "track" (the per-dim
    sequential filter batched by track) on the CPU, else the SoA
    filter's scan, "associative" or "blocked"."""
    if device.type != "cuda":
        return "track"
    return "blocked" if n >= TWIN_SOA_MIN_STEPS else "associative"


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
    """Everything the fitting layer needs. For the closed-form models the
    joint nllk is plain tensor arithmetic (torch.func transforms it: the
    Laplace inner Newton, the log-det gradient, the joint precision); for
    the state-space models it runs through reverse-only kernels."""

    joint_nllk: Callable  # penalized, fn(full_params_dict) -> 0-d tensor
    joint_nllk_unpenalized: Callable  # the penalty dropped (twin route)
    packer: ParamPacker
    par_matrix: Callable  # fn(full_params_dict) -> (n, n_par) working scale
    n_obs: int
    dtype: torch.dtype
    device: torch.device
    kind: str = ""  # 'closed_form' | 'ssm'
    # the forward-mode-capable twin of joint_nllk (joint_nllk itself for
    # the closed-form models); without a mesh joint_nllk_ad_flat is it
    joint_nllk_ad: Optional[Callable] = None
    joint_nllk_ad_flat: Optional[Callable] = None
    hess_plan: Optional[dict] = None  # colored inner-Hessian plan
    twin: str = ""  # the twin's route (`twin_route`), state-space only
    marginal: Optional[Callable] = None  # the Laplace marginal, made once
    # the unpenalized log-likelihood on the value route (`kalman_impl`)
    loglik: Optional[Callable] = None


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
    reml: bool = False,
    kalman_impl: str = "auto",
    *,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> ObjectiveBundle:
    other_data = dict(other_data or {})
    fixpar = list(fixpar or [])
    init = dict(init or {})
    map_fix = dict(map_fix or {})
    check_slice(spec, other_data)
    kalman_impl = IMPL_ALIASES.get(kalman_impl, kalman_impl)
    if kalman_impl not in KALMAN_IMPLS + UNPORTED_IMPLS:
        raise ValueError(f"unknown kalman_impl {kalman_impl!r}")
    if spec.kind == "ssm" and kalman_impl in UNPORTED_IMPLS:
        raise unported(f"kalman_impl={kalman_impl!r}", "generic")
    device = resolve_device(device)
    n, n_dim = obs.shape
    param_names = list(spec.param_names)
    n_par = len(param_names)
    closed_form = spec.kind == "closed_form"

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
    re_blocks = [dev(X) for X in design.re_blocks()]
    ncol_re_per_param = [X.shape[1] for X in design.re_blocks()]
    fe_off = np.concatenate([[0], np.cumsum(design.ncol_fe)]).astype(int)
    re_off = np.concatenate([[0], np.cumsum(ncol_re_per_param)]).astype(int)
    p_fe = int(fe_off[-1])
    p_re = int(re_off[-1])
    n_smooth = design.n_lambda
    has_re = p_re > 0

    # the per-step data (observations, f64-derived intervals, masks) is
    # built once on the device, not per evaluation
    if closed_form:
        data = prepare_closed_form_data(obs, times, ids, dtype=dtype,
                                        device=device,
                                        dt=precompute_dt(times, ids))
    elif spec.type == "CTCRW":
        data = prepare_ctcrw_data(obs, times, ids, dtype=dtype, device=device)
    else:
        data = prepare_diag_data(spec.type, obs, times, ids, dtype=dtype,
                                 device=device)
    twin = "" if closed_form else twin_route(device, n)
    sequential = not closed_form and kalman_impl == "sequential"
    if twin == "track" or sequential:
        # the sequential filter's own copy of the data and its host plan,
        # made once outside every transform
        obs_t = dev(obs)
        ids_t = torch.as_tensor(np.asarray(ids), device=device)
        dt_t = dev(precompute_dt(times, ids))
        track_plan = track_pad_plan(ids, device=device)

    def perdim_steps(full, sobs):
        pm = par_matrix(full)
        if spec.type == "CTCRW":
            return ctcrw_steps_perdim(pm, obs_t, None, ids_t, sigma_obs=sobs,
                                      dt=dt_t)
        return diag_ssm_steps_perdim(spec.type, pm, obs_t, None, ids_t,
                                     sigma_obs=sobs, dt=dt_t)

    # ---- decay-modulated splines (closed-form models only,
    #      R/sde.R:634-653, nllk_sde.hpp:47-58) ----
    decay_enabled = closed_form and other_data.get("t_decay") is not None
    decay_cols: Dict[int, List[tuple]] = {}  # param j -> [(col, rate idx)]
    n_decay = 1
    t_decay_blocks = None
    if decay_enabled:
        t_decay = np.asarray(other_data["t_decay"], float)
        if t_decay.size != n * n_par:
            raise ValueError(
                "'t_decay' should have length (number of parameters) x "
                "(number of data)"
            )
        col_decay = np.atleast_1d(np.asarray(other_data["col_decay"], int))
        ind_decay = np.atleast_1d(np.asarray(other_data["ind_decay"], int))
        if len(col_decay) != len(ind_decay):
            raise ValueError("'col_decay' and 'ind_decay' lengths differ")
        n_decay = int(len(np.unique(ind_decay)))
        t_decay_blocks = dev(t_decay.reshape(n_par, n))
        for c, ind in zip(col_decay, ind_decay):
            c0 = int(c) - 1  # 1-based as in the reference
            j = int(np.searchsorted(re_off, c0, side="right") - 1)
            decay_cols.setdefault(j, []).append(
                (c0 - int(re_off[j]), int(ind) - 1))

    # ---- parameter blocks (same names and order as the JAX package) ----
    def _init(name, size, default=0.0):
        v = np.asarray(init.get(name, np.full(size, default)), float)
        v = v.reshape(-1)
        if v.size != size:
            raise ValueError(f"init for {name!r} has wrong size")
        return v

    blocks: List[ParamBlock] = []
    if not closed_form:
        fixed_sobs = np.array([False])
        if "log_sigma_obs" in map_fix:
            fixed_sobs = np.atleast_1d(
                np.asarray(map_fix["log_sigma_obs"], bool))
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
        blocks.append(ParamBlock(
            "log_sigma_obs", _init("log_sigma_obs", 1, default_ls),
            fixed_sobs))

    # coeff_fe, with fixpar columns pinned (R/sde.R:621-632)
    cfe_fixed = np.zeros(p_fe, bool)
    for j, pname in enumerate(param_names):
        if pname in fixpar:
            cfe_fixed[fe_off[j] : fe_off[j + 1]] = True
    if "coeff_fe" in map_fix:
        cfe_fixed = cfe_fixed | np.asarray(map_fix["coeff_fe"], bool)
    blocks.append(ParamBlock("coeff_fe", _init("coeff_fe", p_fe), cfe_fixed))

    # log_lambda: one per penalty matrix; fixed when there are no smooths
    ll_fixed = np.full(max(n_smooth, 1), not has_re)
    if "log_lambda" in map_fix:
        ll_fixed = ll_fixed | np.asarray(map_fix["log_lambda"], bool)
    blocks.append(ParamBlock(
        "log_lambda", _init("log_lambda", max(n_smooth, 1), 0.0), ll_fixed))

    if decay_enabled:
        blocks.append(ParamBlock(
            "log_decay", _init("log_decay", n_decay, 0.0),
            np.zeros(n_decay, bool)))

    cre_fixed = np.zeros(max(p_re, 1), bool) if has_re else np.ones(1, bool)
    if "coeff_re" in map_fix and has_re:
        cre_fixed = cre_fixed | np.asarray(map_fix["coeff_re"], bool)
    blocks.append(
        ParamBlock("coeff_re", _init("coeff_re", max(p_re, 1)), cre_fixed))

    # REML: integrate the fixed-effect coefficients out alongside the
    # smooth coefficients (TMB's documented REML construction,
    # random=c("coeff_fe", "coeff_re"); the reference only exposes ML,
    # R/sde.R:656-658).
    packer = ParamPacker(
        blocks, inner=("coeff_fe", "coeff_re") if reml else "coeff_re")
    packer.place(dtype, device)

    # ---- linear predictor ----
    def par_matrix(full):
        cfe = full["coeff_fe"]
        cre = full["coeff_re"]
        cols = []
        for j in range(n_par):
            cfe_j = cfe[fe_off[j] : fe_off[j + 1]]
            if fe_const_rows[j] is not None:
                lp = (fe_const_rows[j] @ cfe_j).expand(n)
            else:
                lp = fe_blocks[j] @ cfe_j
            if ncol_re_per_param[j] > 0:
                Xre = re_blocks[j]
                if j in decay_cols:
                    # out of place (torch.func has no in-place column set):
                    # each decayed column scaled by exp(-rate * t_decay)
                    rate = torch.exp(full["log_decay"])
                    xcols = list(Xre.unbind(1))
                    for local, rix in decay_cols[j]:
                        xcols[local] = xcols[local] * torch.exp(
                            -rate[rix] * t_decay_blocks[j])
                    Xre = torch.stack(xcols, dim=1)
                lp = lp + Xre @ cre[re_off[j] : re_off[j + 1]]
            cols.append(lp)
        return torch.stack(cols, dim=1)

    # ---- likelihood ----
    if closed_form:
        other = ({"df": float(other_data["df"])} if spec.type == "BM_t"
                 else None)

        def loglik(full):
            return closed_form_loglik(spec.type, None, None, None,
                                      par_matrix(full), other, data=data)
    else:
        def loglik(full):
            sobs = torch.exp(full["log_sigma_obs"][0])
            if sequential:
                return kalman_loglik_batched(perdim_steps(full, sobs))
            if spec.type == "CTCRW":
                return ctcrw_loglik_soa(
                    par_matrix(full), None, None, None, sigma_obs=sobs,
                    scan="fused", analytic_grad=True, data=data,
                )
            return diag_ssm_loglik_fused(
                spec.type, par_matrix(full), None, None, None,
                sigma_obs=sobs, data=data,
            )

        def loglik_ad(full):
            # the forward-mode-capable twin: no kernel, no
            # autograd.Function, so vmap / jvp / grad compose at any order
            sobs = torch.exp(full["log_sigma_obs"][0])
            pm = par_matrix(full)
            if twin != "track":
                if spec.type == "CTCRW":
                    return ctcrw_loglik_soa(pm, None, None, None,
                                            sigma_obs=sobs, scan=twin,
                                            data=data)
                return diag_ssm_loglik_soa(spec.type, pm, None, None, None,
                                           sigma_obs=sobs, scan=twin,
                                           data=data)
            steps = perdim_steps(full, sobs)
            if track_plan is not None:
                steps = batch_steps_by_track(steps, *track_plan)
            return kalman_loglik_batched(steps)

    # ---- penalty ----
    penalty = make_penalty(design.S_groups, normalize=closed_form,
                           dtype=dtype, device=device)

    def joint_nllk(full):
        val = -loglik(full)
        if has_re:
            val = val + penalty(full["coeff_re"], full["log_lambda"])
        return val

    if closed_form:
        joint_nllk_ad = joint_nllk
    else:
        def joint_nllk_ad(full):
            val = -loglik_ad(full)
            if has_re:
                val = val + penalty(full["coeff_re"], full["log_lambda"])
            return val

    def joint_nllk_unpenalized(full):
        # include_penalty = 0: the closed-form dispatcher drops the
        # penalty entirely (nllk_sde.hpp:91); what conditional AIC needs,
        # through the twin (callers take its Hessian)
        return -(loglik if closed_form else loglik_ad)(full)

    # ---- compressed inner-Hessian plan (infer/coloring.py) ----
    # Only when the inner vector is exactly the full coeff_re (ML, no
    # pinned entries): the plan's columns must match the inner vector
    # one to one. A pure optimization: plan_coloring returns None
    # whenever exact reconstruction is not guaranteed.
    hess_plan = None
    if has_re and not reml and not np.asarray(cre_fixed).any() \
            and p_re >= 16:
        from smoothsde_tpu_torch.infer.coloring import plan_coloring

        pg_off = np.concatenate([[0], np.cumsum(design.ncol_re)]).astype(int)
        hess_plan = plan_coloring(design.re_blocks(), [
            (np.arange(pg_off[k], pg_off[k + 1]), design.S_groups[k])
            for k in range(len(design.ncol_re))
        ])

    return ObjectiveBundle(
        joint_nllk=joint_nllk,
        joint_nllk_unpenalized=joint_nllk_unpenalized,
        packer=packer,
        par_matrix=par_matrix,
        n_obs=n,
        dtype=dtype,
        device=device,
        kind=spec.kind,
        joint_nllk_ad=joint_nllk_ad,
        joint_nllk_ad_flat=joint_nllk_ad,
        hess_plan=hess_plan,
        twin=twin,
        loglik=loglik,
    )
