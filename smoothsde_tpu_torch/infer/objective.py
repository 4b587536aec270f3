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
  - the isotropic state-space models (CTCRW, BM_SSM, OU_SSM without a
    user H or P0) on the fused kernels: CTCRW through
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
    TWIN_SOA_MIN_STEPS steps and "associative" below (PERF.md §5);
  - the generic route (a user H (n, m, m) or P0, and ESEAL_SSM with its
    inverse-gamma priors): the full-state steps of models/ssm.py through
    ops/kalman.py `kalman_loglik`, "parallel" on a CUDA device and
    "sequential" on the CPU (`default_filter_impl`); plain tensor
    arithmetic, so it is its own twin, as in the JAX package.

`kalman_impl` picks the isotropic state-space value route
(objective.py:491-583 of the JAX package): "auto" and "soa" the fused
kernels (their plain versions on the CPU), "sequential" and "parallel"
the per-dim filters of ops/kalman.py, "sqrt" the square-root filter
(ops/kalman_sqrt.py; its plain "blocked" scan on a card, "sequential" on
the CPU, as objective.py:540-544). On the generic route "auto" is the
device's filter and "sequential" / "parallel" force one. The bundle's
`loglik` is that route's unpenalized log-likelihood: under torch.no_grad
on a CUDA model with the fused route a value-only pass through the
forward kernels (K1a, K2, K1b for CTCRW; D1a, K2, D1b for BM_SSM /
OU_SSM). For the state-space types the bundle also carries
`filter_states` (the reference's aest_all) and `innovations` (u, F, ok),
from the full-state steps: on a card the parallel filter's filtered
moments, on the CPU the sequential scans (objective.py:636-644).

The data term is `rows_likelihood` of every row. With a `mesh`
(parallel/batching.py) it is the sharded one of parallel/dist.py
(objective.py:649-680 of the JAX package): on the "tracks" axis a sum of
`rows_likelihood` over each shard's whole tracks on its device, value and
twin; on the "time" axis the time-sharded kernel cores for CTCRW, BM_SSM
and OU_SSM with a sharded SoA scan as their twin, and the time-sharded
full-state filter on the generic route. On a ("dcn", axis) mesh each
process evaluates its shards and the parts are summed across the
processes here (`data_term`: parallel/collectives.py `replicate` and
`process_sum`), value and twin alike, so every process holds the same
objective, gradient and second-order quantities. ESEAL_SSM's priors are
added once, outside the sharded sum; `joint_nllk_ad_flat` stays the twin
without the mesh (the joint precision's; every process evaluates it
whole).

With random effects and no REML or pinned entries, p_re >= 16 inner
coefficients get a colored Hessian plan (infer/coloring.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from smoothsde_tpu_torch.infer.params import ParamBlock, ParamPacker
from smoothsde_tpu_torch.models.registry import ModelSpec
from smoothsde_tpu_torch.models.ssm import (
    SSM_STEP_BUILDERS,
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
    default_filter_impl,
    filtered_to_reported_states,
    kalman_filter_parallel,
    kalman_innovations,
    kalman_loglik,
    kalman_loglik_batched,
    kalman_loglik_sequential,
    track_pad_plan,
)
from smoothsde_tpu_torch.ops.kalman_soa import (
    ctcrw_loglik_soa,
    diag_ssm_loglik_soa,
    precompute_dt,
    prepare_ctcrw_data,
)
from smoothsde_tpu_torch.ops.kalman_sqrt import (
    ctcrw_loglik_sqrt,
    diag_ssm_loglik_sqrt,
)
from smoothsde_tpu_torch.ops.penalty import make_penalty
from smoothsde_tpu_torch.parallel.collectives import process_sum, replicate

# setup(kalman_impl=...) choices (the JAX package's); "soa" is the JAX
# package's name for the route "auto" takes here
KALMAN_IMPLS = ("auto", "sequential", "parallel", "sqrt")
IMPL_ALIASES = {"soa": "auto"}


def _dinvgamma_log(x, shape, scale):
    """Inverse-gamma log-density (nllk_e_seal_ssm.hpp:68-78) at x, a
    tensor; shape and scale floats, filled on x's device in x's shape (no
    host copy; no 0-d operand)."""
    a, b = x.new_full(x.shape, shape), x.new_full(x.shape, scale)
    return a * torch.log(b) - torch.special.gammaln(a) - \
        (a + 1.0) * torch.log(x) - b / x


def eseal_priors(priors, n: int) -> dict:
    """The ESEAL_SSM inverse-gamma priors on sigma^2 and tau^2 as
    {"sigma2": (shape, scale), "tau2": (shape, scale)}: "schick2013" (the
    default; the reference's hard-coded Schick et al. (2013) values,
    nllk_e_seal_ssm.hpp:215-216), None or "none" (no priors), or a dict
    with either key."""
    if isinstance(priors, str) and priors == "schick2013":
        return {"sigma2": (10.0 * n, 4.0 * (10.0 * n - 1.0)),
                "tau2": (n / 2.0, n / 2.0 - 1.0)}
    if priors is None or (isinstance(priors, str) and priors == "none"):
        return {}
    if not isinstance(priors, dict):
        raise ValueError(
            "other_data['priors'] must be 'schick2013', None, or a dict "
            "with 'sigma2'/'tau2' (shape, scale) entries"
        )
    return dict(priors)


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
    # the closed-form models), and that twin without the mesh
    joint_nllk_ad: Optional[Callable] = None
    joint_nllk_ad_flat: Optional[Callable] = None
    filter_states: Optional[Callable] = None  # SSMs: fn(full) -> (n, s)
    innovations: Optional[Callable] = None  # SSMs: fn(full) -> (u, F, ok)
    hess_plan: Optional[dict] = None  # colored inner-Hessian plan
    # the twin's route (`twin_route`, or the generic filter's impl),
    # state-space only
    twin: str = ""
    marginal: Optional[Callable] = None  # the Laplace marginal, made once
    # the unpenalized log-likelihood on the value route (`kalman_impl`)
    loglik: Optional[Callable] = None
    # the mesh of a sharded likelihood (parallel/batching.Mesh), or None
    mesh: Optional[object] = None

    @property
    def uses_mesh(self) -> bool:
        return self.mesh is not None


class Likelihood(NamedTuple):
    """The data term of the log-likelihood over a set of whole tracks, as
    functions of (full, par_mat): the named parameter tensors and the
    (rows, n_par) working-scale linear predictor on the rows' device.
    `value` is the route of `kalman_impl` (the kernels for the isotropic
    state-space models), `ad` its forward-mode-capable twin (`value`
    itself where that is plain tensor arithmetic), `twin` the twin's
    route, `full_steps` the full-state steps of models/ssm.py (state-space
    models; the generic filter's input and the diagnostics')."""

    value: Callable
    ad: Callable
    twin: str
    full_steps: Optional[Callable] = None


def rows_likelihood(spec: ModelSpec, obs, times, ids, other_data, H_array,
                    P0, kalman_impl: str, *, dtype, device) -> Likelihood:
    """The Likelihood of the rows (obs, times, ids): whole tracks, their
    per-step data built once on `device` in `dtype`. `other_data`'s
    per-row arrays (ESEAL_SSM's h, R, dep_fat) and H_array ((rows, m, m))
    are the rows' own; build_objective calls it on every row, the
    track-sharded likelihood (parallel/dist.py) on each shard's."""
    n = len(ids)
    closed_form = spec.kind == "closed_form"
    eseal = spec.type == "ESEAL_SSM"
    # the generic route: the full-state filter (ESEAL_SSM, user H or P0)
    generic = not closed_form and (eseal or H_array is not None
                                   or P0 is not None)
    if generic and kalman_impl == "sqrt":
        raise ValueError(
            "kalman_impl='sqrt' needs isotropic observation noise and the "
            "default P0 (the square-root filter is per dim)"
        )
    filter_impl = (default_filter_impl(device) if kalman_impl == "auto"
                   else kalman_impl)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=device, dtype=dtype
        )

    # the per-step data (observations, f64-derived intervals, masks) is
    # built once on the device, not per evaluation
    if closed_form:
        data = prepare_closed_form_data(obs, times, ids, dtype=dtype,
                                        device=device,
                                        dt=precompute_dt(times, ids))
        other = ({"df": float(other_data["df"])} if spec.type == "BM_t"
                 else None)

        def value(full, pm):
            return closed_form_loglik(spec.type, None, None, None, pm, other,
                                      data=data)

        return Likelihood(value, value, "")
    if spec.type == "CTCRW" and not generic:
        data = prepare_ctcrw_data(obs, times, ids, dtype=dtype, device=device)
    elif not generic:
        data = prepare_diag_data(spec.type, obs, times, ids, dtype=dtype,
                                 device=device)
    # the generic filter is its own twin
    twin = filter_impl if generic else twin_route(device, n)
    # the filters' own copy of the data and the host track plan, made
    # once outside every transform (the per-dim and full-state steps)
    obs_t = dev(obs)
    ids_t = torch.as_tensor(np.asarray(ids), device=device)
    dt_t = dev(precompute_dt(times, ids))
    track_plan = track_pad_plan(ids, device=device) \
        if twin == "track" else None
    H_t = None if H_array is None else dev(H_array)
    P0_t = None if P0 is None else dev(P0)
    if eseal:
        eseal_data = [dev(other_data[k]) for k in ("h", "R", "dep_fat")]

    def perdim_steps(pm, sobs):
        if spec.type == "CTCRW":
            return ctcrw_steps_perdim(pm, obs_t, None, ids_t, sigma_obs=sobs,
                                      dt=dt_t)
        return diag_ssm_steps_perdim(spec.type, pm, obs_t, None, ids_t,
                                     sigma_obs=sobs, dt=dt_t)

    def full_steps(full, pm):
        if eseal:
            return SSM_STEP_BUILDERS[spec.type](
                pm, obs_t, None, ids_t, full["log_tau"][0], full["a1"][0],
                full["log_a2"][0], *eseal_data, P0=P0_t, dt=dt_t)
        return SSM_STEP_BUILDERS[spec.type](
            pm, obs_t, None, ids_t, sigma_obs=torch.exp(
                full["log_sigma_obs"][0]), H_array=H_t, P0=P0_t, dt=dt_t)

    if generic:
        def value(full, pm):
            return kalman_loglik(full_steps(full, pm), impl=filter_impl)

        return Likelihood(value, value, twin, full_steps)

    def value(full, pm):
        sobs = torch.exp(full["log_sigma_obs"][0])
        if kalman_impl in ("sequential", "parallel"):
            return kalman_loglik_batched(perdim_steps(pm, sobs),
                                         impl=kalman_impl)
        if kalman_impl == "sqrt":
            # the square-root filter, by plain AD through its scan
            scan = "blocked" if device.type == "cuda" else "sequential"
            if spec.type == "CTCRW":
                return ctcrw_loglik_sqrt(pm, None, None, None, sigma_obs=sobs,
                                         scan=scan, data=data)
            return diag_ssm_loglik_sqrt(spec.type, pm, None, None, None,
                                        sigma_obs=sobs, scan=scan, data=data)
        if spec.type == "CTCRW":
            return ctcrw_loglik_soa(pm, None, None, None, sigma_obs=sobs,
                                    scan="fused", analytic_grad=True,
                                    data=data)
        return diag_ssm_loglik_fused(spec.type, pm, None, None, None,
                                     sigma_obs=sobs, data=data)

    def ad(full, pm):
        sobs = torch.exp(full["log_sigma_obs"][0])
        if twin != "track":
            if spec.type == "CTCRW":
                return ctcrw_loglik_soa(pm, None, None, None, sigma_obs=sobs,
                                        scan=twin, data=data)
            return diag_ssm_loglik_soa(spec.type, pm, None, None, None,
                                       sigma_obs=sobs, scan=twin, data=data)
        steps = perdim_steps(pm, sobs)
        if track_plan is not None:
            steps = batch_steps_by_track(steps, *track_plan)
        return kalman_loglik_batched(steps, impl="sequential")

    return Likelihood(value, ad, twin, full_steps)


def _check_mesh(mesh, mesh_axis: str, device: torch.device):
    """The mesh of a sharded fit, checked against the model's device."""
    if mesh_axis != mesh.axis:
        raise ValueError(f"mesh has no shard axis {mesh_axis!r} "
                         f"(axes {mesh.axis_names})")
    if any(d.type != device.type for d in mesh.devices):
        raise ValueError(
            f"mesh devices {mesh.devices} are not of the model's device "
            f"type {device.type!r}")
    return mesh


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
    mesh=None,
    mesh_axis: str = "tracks",
    *,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> ObjectiveBundle:
    other_data = dict(other_data or {})
    fixpar = list(fixpar or [])
    init = dict(init or {})
    map_fix = dict(map_fix or {})
    kalman_impl = IMPL_ALIASES.get(kalman_impl, kalman_impl)
    if kalman_impl not in KALMAN_IMPLS:
        raise ValueError(f"unknown kalman_impl {kalman_impl!r}")
    device = resolve_device(device)
    n, n_dim = obs.shape
    param_names = list(spec.param_names)
    n_par = len(param_names)
    closed_form = spec.kind == "closed_form"
    eseal = spec.type == "ESEAL_SSM"

    # the user's observation covariance, (n, m, m) or (m, m, n) as the
    # reference takes it (R/sde.R:563-568), and initial covariance
    H_array = other_data.get("H")
    if H_array is not None:
        H_array = np.asarray(H_array, float)
        if H_array.ndim == 3 and H_array.shape[0] != n and \
                H_array.shape[-1] == n:
            H_array = np.moveaxis(H_array, -1, 0)
    P0 = other_data.get("P0")
    if mesh is not None:
        mesh = _check_mesh(mesh, mesh_axis, device)

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
    if eseal:
        # initial values of R/sde.R:606-609
        for name, default in (("log_tau", 0.0), ("a1", -0.578),
                              ("log_a2", float(np.log(1.214)))):
            fixed = np.atleast_1d(np.asarray(map_fix.get(name, [False]),
                                             bool))
            blocks.append(ParamBlock(name, _init(name, 1, default), fixed))
    elif not closed_form:
        # sigma_obs is fixed when the user gives H (objective.py:267)
        fixed_sobs = np.array([H_array is not None])
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
    lik = rows_likelihood(spec, obs, times, ids, other_data, H_array, P0,
                          kalman_impl, dtype=dtype, device=device)
    priors = eseal_priors(other_data.get("priors", "schick2013"), n) \
        if eseal else {}

    def prior_terms(full):
        """The inverse-gamma priors of ESEAL_SSM (0 otherwise), added once
        outside a sharded sum, on (1,) tensors: a float times a 0-d
        tensor promotes f32 under jvp-of-grad."""
        llk = 0.0
        if "sigma2" in priors:
            sigma0 = torch.exp(par_matrix(full)[:1, 1])
            llk = llk + _dinvgamma_log(sigma0**2, *priors["sigma2"]).sum()
        if "tau2" in priors:
            tau = torch.exp(full["log_tau"])
            llk = llk + _dinvgamma_log(tau**2, *priors["tau2"]).sum()
        return llk

    value, value_ad = lik.value, lik.ad
    if mesh is not None:
        from smoothsde_tpu_torch.parallel import dist

        if mesh_axis == "time":
            sharded = dist.build_time_sharded_loglik(
                spec, obs, times, ids, mesh, mesh_axis, other_data, H_array,
                P0, kalman_impl, dtype=dtype, device=device)
        else:
            sharded = dist.build_sharded_loglik(
                spec, obs, times, ids, mesh, mesh_axis, other_data,
                kalman_impl, H_array, P0, dtype=dtype)
        value, value_ad = sharded.loglik, sharded.loglik_ad

    procs = None if mesh is None else mesh.processes

    def data_term(fn, full):
        """fn(full, par_matrix(full)); on a ("dcn", axis) mesh this
        process's part, summed over the processes: the parameters enter
        through `replicate`, whose backward sums their cotangents, the
        one place where the gradient crosses processes."""
        if procs is None:
            return fn(full, par_matrix(full))
        full = replicate(full, procs)
        return process_sum(fn(full, par_matrix(full)), procs)

    def loglik(full):
        return data_term(value, full) + prior_terms(full)

    def loglik_ad(full):
        # the forward-mode-capable twin: no kernel, no autograd.Function
        # but the collectives' (which carry their own rules), so vmap /
        # jvp / grad compose at any order
        return data_term(value_ad, full) + prior_terms(full)

    def loglik_ad_flat(full):
        # the twin without the mesh: the joint precision's Hessian
        return lik.ad(full, par_matrix(full)) + prior_terms(full)

    filter_states = innovations = None
    if not closed_form:
        states_impl = default_filter_impl(device)

        def filter_states(full):
            """(n, s) state estimates after each observation (aest_all)."""
            steps = lik.full_steps(full, par_matrix(full))
            if states_impl == "parallel":
                return filtered_to_reported_states(
                    steps, kalman_filter_parallel(steps)[1])
            return kalman_loglik_sequential(steps, with_states=True)[1]

        def innovations(full):
            """(u (n, m), F (n, m, m), ok (n,)), ops/kalman.py
            `kalman_innovations`."""
            return kalman_innovations(lik.full_steps(full, par_matrix(full)),
                                      impl=states_impl)

    # ---- penalty ----
    penalty = make_penalty(design.S_groups, normalize=closed_form,
                           dtype=dtype, device=device)

    def _joint(loglik_fn):
        def joint(full):
            val = -loglik_fn(full)
            if has_re:
                val = val + penalty(full["coeff_re"], full["log_lambda"])
            return val

        return joint

    joint_nllk = _joint(loglik)
    # the closed-form value route is plain torch, its own twin
    joint_nllk_ad = joint_nllk if closed_form else _joint(loglik_ad)
    joint_nllk_ad_flat = joint_nllk_ad if mesh is None \
        else _joint(loglik_ad_flat)

    def joint_nllk_unpenalized(full):
        # include_penalty = 0: the closed-form dispatcher drops the
        # penalty entirely (nllk_sde.hpp:91); what conditional AIC needs,
        # through the twin (callers take its Hessian)
        return -loglik_ad(full)

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
        joint_nllk_ad_flat=joint_nllk_ad_flat,
        filter_states=filter_states,
        innovations=innovations,
        hess_plan=hess_plan,
        twin=lik.twin,
        loglik=loglik,
        mesh=mesh,
    )
