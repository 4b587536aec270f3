"""The SDE model class: user-facing API of the PyTorch port.

Port of smoothsde_tpu/api/sde.py: construction from formulas + data,
fitting by marginal maximum likelihood (host BFGS, or the L-BFGS with
its state on the device: `fit(optimizer="device" | "auto")`), the outer
covariance `cov_fixed` and the joint precision, parameter evaluation
with inverse links (`linear_predictor`, `par`, prediction grids),
posterior draws and confidence intervals, model selection (`log_lik`,
`edf_conditional`, AIC, BIC), residuals, simulation and posterior
predictive checks, plots, printing, checkpoints in the JAX package's
.npz format, the filtered states and whitened innovations of every
state-space model, and the smoothed states of a fitted CTCRW. Every type
takes smooths and random effects, integrated out by the Laplace
approximation (infer/laplace.py), and REML; the closed-form models (BM,
BM_t, OU, CIR) also decay-modulated splines. The isotropic state-space
models (CTCRW, BM_SSM, OU_SSM) run their likelihood on the hand-written
kernels and the Laplace layer's second-order quantities on a
forward-mode twin (infer/objective.py `loglik_ad`); with a user H or P0,
and ESEAL_SSM, on the generic full-state filter (ops/kalman.py), the
parallel one on a card. `fit(mesh=..., mesh_axis="tracks" | "time")`
shards the likelihood over a device mesh (parallel/), across processes
too.

The device and the working type are explicit: `device="cuda"` (the
default) runs the hand-written CUDA kernels, `device="cpu"` their plain
PyTorch versions; a CUDA request without a card raises. `dtype` is
float32 by default (as the JAX package on the TPU) or float64.
Indices are 0-based (`t=0` is the first row).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from smoothsde_tpu_torch.formula.design import ColumnData, build_design
from smoothsde_tpu_torch.formula.parser import parse_formula
from smoothsde_tpu_torch.infer.objective import resolve_device
from smoothsde_tpu_torch.models.registry import get_model_spec, model_eqn
from smoothsde_tpu_torch.utils.grids import cov_grid
from smoothsde_tpu_torch.utils.misc import prec_to_cov
from smoothsde_tpu_torch.utils.profiling import StageTimer


class SDE:
    """Varying-coefficient SDE model (the port's slice).

    Args:
      formulas: dict mapping SDE parameter names to formula strings, in
        the model's parameter order: intercepts, linear/factor terms,
        smooths `s(...)` and random effects `s(ID, bs='re')`. None =
        intercept-only for all.
      data: pandas DataFrame or dict of columns with a "time" column, the
        response column(s), covariates, and optionally "ID" (tracks).
      type: model type; the port runs the closed-form "BM" (parameters
        mu.., sigma), "BM_t" (mu, sigma; df in other_data), "OU" (mu..,
        tau, kappa) and "CIR" (mu.., beta, sigma), and the state-space
        "CTCRW" (mu.., tau, nu), "BM_SSM" (mu.., sigma) and "OU_SSM"
        (mu.., tau, kappa), each with Gaussian measurement error of SD
        sigma_obs (fitted) or the user's H, and "ESEAL_SSM" (mu, sigma;
        with log_tau, a1, log_a2 fitted beside them).
      response: response column name, or list of names (multivariate).
      par0: optional initial response-scale values, one per parameter
        (sequence in parameter order, or dict keyed by name).
      fixpar: names of SDE parameters fixed at their par0 value.
      other_data: model extras: "df" (BM_t); "t_decay" with "col_decay"
        (or "decay_term") and "ind_decay" for decay-modulated splines of
        the closed-form models (R/sde.R:163-181); "H", the per-row
        observation covariance (n, m, m) or (m, m, n), and "P0", the
        initial state covariance, of the state-space models
        (R/sde.R:547-603); "h", "R", "dep_fat" and "priors"
        ("schick2013" by default, None, or a dict of inverse-gamma
        (shape, scale) under "sigma2" / "tau2") of ESEAL_SSM.
      device: "cuda" (default) or "cpu"; never chosen automatically.
      dtype: torch.float32 (default) or torch.float64.
    """

    def __init__(
        self,
        formulas=None,
        data=None,
        type: str = "BM",
        response: Union[str, Sequence[str]] = None,
        par0=None,
        fixpar: Optional[List[str]] = None,
        other_data: Optional[dict] = None,
        knots: Optional[dict] = None,
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        if data is None or response is None:
            raise ValueError("'data' and 'response' are required")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError("dtype must be torch.float32 or torch.float64")
        self._device = resolve_device(device)
        self._dtype = dtype
        self._type = type
        responses = [response] if isinstance(response, str) else list(response)
        self._response = responses
        self._fixpar = list(fixpar or [])

        # the build's stages (FitResult.timings of every fit of it)
        self._build_timer = StageTimer()
        with self._build_timer.stage("build.columns"):
            cdata = ColumnData(data)
            for r in responses:
                if r not in cdata:
                    raise ValueError("'response' not found in 'data'")

            self._spec = get_model_spec(type, len(responses))
            param_names = list(self._spec.param_names)

            if formulas is None:
                formulas = {p: "~1" for p in param_names}
            if list(formulas.keys()) != param_names:
                raise ValueError(
                    f"'formulas' should have components "
                    f"{', '.join(param_names)} for the model {type}"
                )
            for p in self._fixpar:
                f = formulas[p]
                parsed = parse_formula(f if isinstance(f, str) else f.source)
                if parsed.linear_terms or parsed.smooth_terms:
                    raise ValueError(
                        "formulas should be ~1 for fixed parameters")
            self._formulas = {
                p: (f if isinstance(f, str) else f.source)
                for p, f in formulas.items()
            }

            if "ID" not in cdata:
                warnings.warn(
                    "No ID column found in 'data', assuming same ID for all "
                    "observations",
                    stacklevel=2,
                )
                data = dict(data) if isinstance(data, dict) else data.copy()
                data["ID"] = np.zeros(cdata.n, int)
                cdata = ColumnData(data)
            if "time" not in cdata:
                raise ValueError("'data' should have a time column")
            self._data = cdata
            self._id_levels = cdata.levels("ID")
            lvl_index = {lv: i for i, lv in enumerate(self._id_levels)}
            self._ids = np.array([lvl_index[v]
                                  for v in cdata.raw("ID").tolist()])
            self._times = cdata.numeric("time")
            self._obs = np.column_stack([cdata.numeric(r) for r in responses])

        with self._build_timer.stage("build.design"):
            self._knots = dict(knots or {})
            self._design = build_design(self._formulas, cdata,
                                        knots=self._knots)
            self._terms = {
                "ncol_fe": list(self._design.ncol_fe),
                "ncol_re": list(self._design.ncol_re),
                "names_fe": list(self._design.names_fe),
                "names_re_all": list(self._design.names_re),
                "names_re": list(self._design.ncol_re_names),
                "fe_col_terms": list(self._design.fe_col_terms),
                "re_col_terms": list(self._design.re_col_terms),
            }
            ncol_fe = list(self._design.ncol_fe)
            self._coeff_fe = np.zeros(sum(ncol_fe))
            self._coeff_re = np.zeros(sum(self._design.ncol_re))
            self._lambda = np.ones(self._design.n_lambda)
            if par0 is not None:
                if isinstance(par0, dict):
                    missing = [p for p in param_names if p not in par0]
                    extra = [k for k in par0 if k not in param_names]
                    if missing or extra:
                        raise ValueError(
                            f"'par0' dict must have exactly one entry per "
                            f"SDE parameter ({', '.join(param_names)}); "
                            f"missing: {missing or 'none'}, unknown: "
                            f"{extra or 'none'}"
                        )
                    par0 = [par0[p] for p in param_names]
                if len(par0) != len(param_names):
                    raise ValueError(
                        f"'par0' should be of length {len(param_names)} with "
                        f"one entry for each SDE parameter "
                        f"({', '.join(param_names)})"
                    )
                i0 = np.concatenate([[0], np.cumsum(ncol_fe)[:-1]]).astype(
                    int)
                for i, (v, p) in enumerate(zip(par0, self._spec.params)):
                    self._coeff_fe[i0[i]] = float(p.link(float(v)))

        # decay bookkeeping (R/sde.R:163-181)
        other_data = dict(other_data or {})
        if type == "BM_t" and other_data.get("df") is None:
            raise ValueError("BM_t needs the degrees of freedom "
                             "other_data['df']")
        if other_data.get("t_decay") is not None:
            if other_data.get("col_decay") is None:
                decay_term = other_data.get("decay_term")
                if decay_term is None:
                    raise ValueError(
                        "decay model needs 'col_decay' or 'decay_term'"
                    )
                other_data["col_decay"] = [
                    i + 1
                    for i, nm in enumerate(self._design.names_re)
                    if nm.startswith(decay_term)
                ]
            t_decay = np.asarray(other_data["t_decay"], float)
            if t_decay.size != len(param_names) * cdata.n:
                raise ValueError(
                    "'t_decay' should be of length (number of parameters) "
                    "x (number of data)"
                )
            if len(np.atleast_1d(other_data["col_decay"])) != len(
                np.atleast_1d(other_data["ind_decay"])
            ):
                raise ValueError(
                    "Check length of 'ind_decay' and 'col_decay'"
                )
            self._rho = np.ones(
                len(np.unique(np.atleast_1d(other_data["ind_decay"])))
            )
        else:
            self._rho = np.ones(1)
        self._other_data = other_data
        self._bundle = None
        self._reml = False
        self._fit_result = None

        self._kalman_impl = "auto"

    # ------------------------------------------------------------------
    # Accessors (R/sde.R:184-326)
    # ------------------------------------------------------------------

    def formulas(self) -> Dict[str, str]:
        return dict(self._formulas)

    def data(self):
        return self._data

    def type(self) -> str:
        return self._type

    def response(self) -> List[str]:
        return list(self._response)

    def fixpar(self) -> List[str]:
        return list(self._fixpar)

    def other_data(self) -> dict:
        return dict(self._other_data)

    def link(self):
        return {p.name: p.link for p in self._spec.params}

    def invlink(self):
        return {p.name: p.invlink for p in self._spec.params}

    def coeff_fe(self) -> np.ndarray:
        return self._coeff_fe.copy()

    def coeff_re(self) -> np.ndarray:
        return self._coeff_re.copy()

    def lambda_(self) -> np.ndarray:
        return self._lambda.copy()

    def sdev(self) -> np.ndarray:
        """SD = 1/sqrt(lambda) per smooth (R/sde.R:223-229)."""
        return 1.0 / np.sqrt(self._lambda)

    def rho(self) -> np.ndarray:
        """Decay rates (one per `ind_decay` level; 1 without decay)."""
        return self._rho.copy()

    def terms(self) -> dict:
        return {k: list(v) for k, v in self._terms.items()}

    def spec(self):
        return self._spec

    def n_obs(self) -> int:
        return self._data.n

    def obs(self) -> np.ndarray:
        return self._obs.copy()

    def out(self):
        """The result of the last fit()."""
        if self._fit_result is None:
            raise RuntimeError("Fit model first")
        return self._fit_result

    def res(self):  # alias used in reference docs
        return self.out()

    def mats(self) -> dict:
        return {
            "X_fe": self._design.stacked_X_fe(),
            "X_re": self._design.stacked_X_re(),
            "S": self._design.stacked_S(),
        }

    def design(self):
        return self._design

    def X_re_decay(self) -> np.ndarray:
        """Stacked X_re with decay-modulated columns (R/sde.R:303-326)."""
        if self._other_data.get("t_decay") is None:
            raise RuntimeError("This model has no decaying terms")
        X_re = self._design.stacked_X_re().copy()
        t_decay = np.asarray(self._other_data["t_decay"], float).reshape(-1)
        col_decay = np.atleast_1d(self._other_data["col_decay"])
        ind_decay = np.atleast_1d(self._other_data["ind_decay"])
        for c, ind in zip(col_decay, ind_decay):
            X_re[:, int(c) - 1] *= np.exp(-self._rho[int(ind) - 1] * t_decay)
        return X_re

    # ------------------------------------------------------------------
    # Mutators (R/sde.R:328-360)
    # ------------------------------------------------------------------

    def update_coeff_fe(self, new_coeff):
        self._coeff_fe = np.asarray(new_coeff, float).reshape(-1)
        self._bundle = None

    def update_coeff_re(self, new_coeff):
        self._coeff_re = np.asarray(new_coeff, float).reshape(-1)
        self._bundle = None

    def update_lambda(self, new_lambda):
        self._lambda = np.asarray(new_lambda, float).reshape(-1)
        self._bundle = None

    def update_rho(self, new_rho):
        self._rho = np.asarray(new_rho, float).reshape(-1)

    # ------------------------------------------------------------------
    # Design matrices (R/sde.R:362-479)
    # ------------------------------------------------------------------

    def make_mat(self, new_data=None, sparse: bool = False) -> dict:
        """Stacked design matrices, optionally for new covariate data
        (R/sde.R:378-455). sparse=True returns scipy CSR matrices (the
        reference's as_sparse conversion, utility.R:204-213)."""
        ev = self._design
        if new_data is not None:
            ev = ev.eval(new_data if isinstance(new_data, ColumnData)
                         else ColumnData(new_data))
        X_fe, X_re = ev.stacked_X_fe(), ev.stacked_X_re()
        S = self._design.stacked_S()
        if sparse:
            import scipy.sparse as sp

            X_fe, X_re, S = (sp.csr_matrix(X_fe), sp.csr_matrix(X_re),
                             sp.csr_matrix(S))
        return {
            "X_fe": X_fe,
            "X_re": X_re,
            "S": S,
            "ncol_fe": list(self._design.ncol_fe),
            "ncol_re": list(self._design.ncol_re),
        }

    def make_mat_grid(self, var: str, covs=None) -> dict:
        """Design matrices over a grid of `var` (R/sde.R:467-479)."""
        var_names = []
        for f in self._formulas.values():
            var_names.extend(parse_formula(f).variables())
        grid = cov_grid(var, self._data, var_names, covs=covs)
        mats = self.make_mat(new_data=grid)
        mats["new_data"] = grid
        return mats

    # ------------------------------------------------------------------
    # Fitting
    # ------------------------------------------------------------------

    def setup(self, map=None, kalman_impl: str = "auto", mesh=None,
              mesh_axis: str = "tracks", reml: bool = False):
        """Build the objective bundle (TMB MakeADFun equivalent) on this
        model's device and dtype, initialized at the current
        coefficients, smoothing parameters and decay rates.

        `kalman_impl` (state-space types): "auto" or "soa" (the fused
        kernels on a CUDA model, their plain versions on the CPU),
        "sequential" or "parallel" (the per-dim filters of
        ops/kalman.py), or "sqrt" (the square-root filter,
        ops/kalman_sqrt.py: the accuracy-optimal route for long f32
        horizons); with a user H or P0, and for ESEAL_SSM, "auto" is the
        full-state filter of the device ("parallel" on a card) and
        "sequential" / "parallel" force one.

        With `mesh` (a parallel/batching.Mesh of devices of this model's
        kind, or "auto": every card, or the CPU, `auto_mesh`) the
        likelihood is sharded over its axis `mesh_axis`: "tracks" (whole
        tracks per shard) or "time" (one long sequence cut into chunks,
        stitched across their edges); parallel/dist.py. Under an
        initialized torch.distributed group of several processes "auto"
        is a ("dcn", mesh_axis) mesh over them (each runs the same fit on
        the whole data and evaluates its own shards). The reference has
        no counterpart (it is single-threaded, nllk_sde.hpp:77-84).

        The bundle keeps the build's stages (`SDE(...)`'s and
        `build_objective`'s), which every fit of it reports in
        `FitResult.timings`."""
        from smoothsde_tpu_torch.infer.objective import build_objective

        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError("mesh must be a Mesh or 'auto'")
            from smoothsde_tpu_torch.parallel.batching import auto_mesh

            mesh = auto_mesh(axis=mesh_axis, device=self._device)
        init = {
            "coeff_fe": self._coeff_fe,
            "coeff_re": (
                self._coeff_re if len(self._coeff_re) else np.zeros(1)
            ),
            "log_lambda": (
                np.log(self._lambda) if len(self._lambda) else np.zeros(1)
            ),
            "log_decay": np.log(self._rho),
        }
        timer = StageTimer()
        timer.merge(self._build_timer)
        self._bundle = build_objective(
            self._spec, self._design, self._obs, self._times, self._ids,
            other_data=self._other_data, fixpar=self._fixpar,
            init=init, map_fix=map, reml=reml, kalman_impl=kalman_impl,
            mesh=mesh, mesh_axis=mesh_axis,
            dtype=self._dtype, device=self._device, timer=timer,
        )
        self._kalman_impl = kalman_impl
        self._reml = reml
        return self._bundle

    def bundle(self):
        if self._bundle is None:
            self.setup()
        return self._bundle

    def _tensor(self, a):
        """`a` as a tensor of the model's dtype on its device."""
        if isinstance(a, torch.Tensor):
            return a.to(dtype=self._dtype, device=self._device)
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self._dtype,
                               device=self._device)

    def _full(self, outer, inner):
        """The bundle's named parameter tensors at (outer, inner)."""
        packer = self.bundle().packer
        return packer.unpack(self._tensor(outer), self._tensor(inner))

    def joint_nllk(self, outer=None, inner=None) -> float:
        """Penalized joint nllk at the given outer and inner vectors
        (tensors on the model's device, or arrays), the bundle's initial
        values where None."""
        packer = self.bundle().packer
        full = self._full(
            packer.outer_init() if outer is None else outer,
            packer.inner_init() if inner is None else inner,
        )
        with torch.no_grad():
            return float(self.bundle().joint_nllk(full))

    def fit(self, silent: bool = True, map=None, mesh=None,
            mesh_axis: str = "tracks", criterion: str = "ML",
            verbose: Optional[bool] = None, **kwargs):
        """Fit by marginal maximum likelihood (R/sde.R:683-720); kwargs
        go to infer.fit.fit_model (method, maxiter, compute_sdreport,
        fd_step, profile_dir, optimizer: "scipy" (default), "device" or
        "auto", sdreport_mode: "auto", "host" or "device").

        `silent` / `verbose`: the reference exposes `silent`
        (R/sde.R:683); `verbose` is the complementary alias and wins when
        given. `criterion`: "ML" (the reference's criterion) or "REML":
        the fixed-effect coefficients are integrated out alongside the
        smooth coefficients (TMB's random=c("coeff_fe", "coeff_re") REML
        construction). `mesh` / `mesh_axis`: fit with the likelihood
        sharded (see `setup`); on a mesh over more than one card or process
        `optimizer="device"` runs its steps eagerly (infer/fit.py)."""
        from smoothsde_tpu_torch.infer.fit import fit_model

        if criterion not in ("ML", "REML"):
            raise ValueError("criterion must be 'ML' or 'REML'")
        if verbose is not None:
            silent = not verbose
        reml = criterion == "REML"
        if not silent:
            self.message()
        if (self._bundle is None or map is not None or mesh is not None
                or self._reml != reml):
            self.setup(map=map, kalman_impl=self._kalman_impl, mesh=mesh,
                       mesh_axis=mesh_axis, reml=reml)
        res = fit_model(self._bundle, verbose=not silent, **kwargs)
        self._fit_result = res
        est = self._bundle.packer.split_estimates(res.par, res.bhat)
        self._coeff_fe = np.asarray(est["coeff_fe"])
        if len(self._coeff_re):
            self._coeff_re = np.asarray(est["coeff_re"])
            self._lambda = np.exp(np.asarray(est["log_lambda"]))
        if self._other_data.get("t_decay") is not None:
            self._rho = np.exp(np.asarray(est["log_decay"]))
        return res

    # ------------------------------------------------------------------
    # Parameters (R/sde.R:722-856)
    # ------------------------------------------------------------------

    def _term_cols(self, term: str):
        """FE/RE column indices whose generating term matches `term`: its
        label ("s(x1)", "x2", "(Intercept)"), its parameter-qualified
        label ("sigma.s(x1)"), or a factor-by level of it ("s(x1):sexF"
        matches "s(x1)"), from the design layer's structured metadata
        (not the reference's substring matching, utility.R:137-144)."""

        def match(param, label):
            return (
                term == label
                or term == f"{param}.{label}"
                or label.startswith(term + ":")
            )

        fe = np.array([i for i, (p, lab) in
                       enumerate(self._terms["fe_col_terms"])
                       if match(p, lab)], int)
        re_ = np.array([i for i, (p, lab) in
                        enumerate(self._terms["re_col_terms"])
                        if match(p, lab)], int)
        return {"fe": fe, "re": re_}

    def _resolve_design(self, new_data=None, X_fe=None, X_re=None):
        if X_fe is None or X_re is None:
            mats = self.make_mat(new_data=new_data)
            X_fe = mats["X_fe"] if X_fe is None else X_fe
            X_re = mats["X_re"] if X_re is None else X_re
        return np.asarray(X_fe), np.asarray(X_re)

    def linear_predictor(self, new_data=None, t="all", X_fe=None, X_re=None,
                         coeff_fe=None, coeff_re=None,
                         term=None) -> np.ndarray:
        """(n_t, n_par) working-scale linear predictor X_fe coeff_fe +
        X_re coeff_re (R/sde.R:749-800), with `make_mat`'s X_re: the
        decay-modulated columns unscaled, as in the reference."""
        X_fe, X_re = self._resolve_design(new_data, X_fe, X_re)
        cfe = self._coeff_fe if coeff_fe is None else np.asarray(coeff_fe)
        cre = self._coeff_re if coeff_re is None else np.asarray(coeff_re)
        if term is not None:
            ti = self._term_cols(term)
            cfe_t = np.zeros_like(cfe)
            cre_t = np.zeros_like(cre)
            cfe_t[ti["fe"]] = cfe[ti["fe"]]
            if len(cre):
                cre_t[ti["re"]] = cre[ti["re"]]
            cfe, cre = cfe_t, cre_t
        lp = X_fe @ cfe
        if X_re.shape[1] and len(cre):
            lp = lp + X_re @ cre
        lp_mat = lp.reshape(len(self._spec.params), -1).T  # (n, n_par)
        if isinstance(t, str) and t == "all":
            return lp_mat
        t_idx = np.atleast_1d(np.asarray(t, int))
        if np.any((t_idx < 0) | (t_idx >= lp_mat.shape[0])):
            raise ValueError(
                f"Elements of 't' should be between 0 and "
                f"{lp_mat.shape[0] - 1}"
            )
        return lp_mat[t_idx]

    def par(self, t=None, new_data=None, X_fe=None, X_re=None,
            coeff_fe=None, coeff_re=None, resp: bool = True,
            term=None) -> np.ndarray:
        """(n_t, n_par) SDE parameters at rows `t` ("all", an index or
        indices; 0 by default, every row when `new_data` or a design
        matrix is given), on the response scale unless resp=False
        (R/sde.R:802-856), through `linear_predictor`."""
        if t is None:
            given = new_data is not None or X_fe is not None or \
                X_re is not None
            t = "all" if given else 0
        lp = self.linear_predictor(
            new_data=new_data, t=t, X_fe=X_fe, X_re=X_re,
            coeff_fe=coeff_fe, coeff_re=coeff_re, term=term,
        )
        if not resp:
            return lp
        out = np.empty_like(lp)
        for i, p in enumerate(self._spec.params):
            out[:, i] = np.asarray(p.invlink(lp[:, i]))
        return out

    def par_names(self) -> List[str]:
        return list(self._spec.param_names)

    # ------------------------------------------------------------------
    # Uncertainty quantification (R/sde.R:858-1180). The draws are NumPy
    # on the host, as in the JAX package: the same rng gives the same
    # draws in both.
    # ------------------------------------------------------------------

    def joint_cov(self) -> np.ndarray:
        res = self.out()
        if res.joint_precision is not None:
            return prec_to_cov(res.joint_precision)
        return res.cov_fixed

    def post_coeff(self, n_post: int, rng=None) -> dict:
        """Posterior draws of all coefficient blocks (R/sde.R:867-922):
        a dict of (n_post, block size) arrays, fixed entries pinned at
        their values. Raises ValueError when the covariance does not
        cover a block's free entries (the JAX package keeps the point
        estimates there instead)."""
        rng = np.random.default_rng() if rng is None else rng
        res = self.out()
        packer = self.bundle().packer
        cov = self.joint_cov()
        # the coordinates the covariance covers (cov_fixed: outer only)
        mean = np.concatenate([res.par, res.bhat])[: cov.shape[0]]
        names = (res.joint_names or res.par_names)[: cov.shape[0]]
        # robust sampling: eigen square root (cov may be near-singular)
        w, V = np.linalg.eigh(0.5 * (cov + cov.T))
        w = np.clip(w, 0.0, None)
        draws = mean + rng.normal(size=(n_post, len(mean))) @ (
            V * np.sqrt(w)
        ).T

        out = {}
        names_arr = np.array(names)
        for block in packer.order:
            cols = np.where(names_arr == block)[0]
            b = packer.blocks[block]
            full = np.tile(np.asarray(b.init, float), (n_post, 1))
            if block == "coeff_fe":
                full = np.tile(self._coeff_fe, (n_post, 1))
            elif block == "coeff_re" and len(self._coeff_re):
                full = np.tile(self._coeff_re, (n_post, 1))
            elif block == "log_lambda" and len(self._lambda):
                full = np.tile(np.log(self._lambda), (n_post, 1))
            free_idx = np.where(~b.fixed)[0]
            if len(free_idx) != len(cols):
                raise ValueError(
                    f"post_coeff: the covariance covers {len(cols)} of the "
                    f"{len(free_idx)} free entries of {block!r} (a fit "
                    f"without the joint precision?); no draws for it"
                )
            full[:, free_idx] = draws[:, cols]
            out[block] = full
        if "coeff_re" not in out or sum(self._terms["ncol_re"]) == 0:
            out["coeff_re"] = np.zeros((n_post, 0))
        return out

    def post_par(self, X_fe, X_re, n_post: int = 100, resp: bool = True,
                 term=None, rng=None) -> np.ndarray:
        """(n_t, n_par, n_post) posterior draws of SDE parameters
        (R/sde.R:924-962)."""
        X_fe = np.asarray(X_fe)
        X_re = np.asarray(X_re)
        post = self.post_coeff(n_post=n_post, rng=rng)
        n_par = len(self._spec.params)
        n_t = X_fe.shape[0] // n_par
        out = np.empty((n_t, n_par, n_post))
        for i in range(n_post):
            out[:, :, i] = self.par(
                t="all", X_fe=X_fe, X_re=X_re,
                coeff_fe=post["coeff_fe"][i],
                coeff_re=(post["coeff_re"][i] if post["coeff_re"].shape[1]
                          else None),
                resp=resp, term=term,
            )
        return out

    def _ci_design(self, t, new_data, X_fe, X_re):
        if t is None:
            given = new_data is not None or X_fe is not None or \
                X_re is not None
            t = "all" if given else 0
        if X_fe is None or X_re is None:
            mats = self.make_mat(new_data=self._subset_rows(new_data, t))
            X_fe, X_re = mats["X_fe"], mats["X_re"]
        return np.asarray(X_fe), np.asarray(X_re)

    def CI_pointwise(self, t=None, new_data=None, X_fe=None, X_re=None,
                     level: float = 0.95, n_post: int = 1000,
                     resp: bool = True, term=None, rng=None) -> np.ndarray:
        """(n_par, 2, n_t) pointwise CIs as posterior quantiles
        (R/sde.R:964-1043)."""
        X_fe, X_re = self._ci_design(t, new_data, X_fe, X_re)
        post = self.post_par(X_fe=X_fe, X_re=X_re, n_post=n_post, resp=resp,
                             term=term, rng=rng)
        alpha = (1.0 - level) / 2.0
        qs = np.quantile(post, [alpha, 1.0 - alpha], axis=2)  # (2, n_t, n_par)
        return np.transpose(qs, (2, 0, 1))  # (n_par, 2, n_t)

    def _subset_rows(self, new_data, t):
        source = new_data
        if source is None:
            source = {c: self._data.raw(c) for c in self._data.columns}
        if isinstance(t, str) and t == "all":
            return source
        t_idx = np.atleast_1d(np.asarray(t, int))
        if isinstance(source, ColumnData):
            source = {c: source.raw(c) for c in source.columns}
        if isinstance(source, dict):
            return {k: np.asarray(v)[t_idx] for k, v in source.items()}
        return source.iloc[t_idx]

    def CI_simultaneous(self, t=None, new_data=None, X_fe=None, X_re=None,
                        level: float = 0.95, n_post: int = 1000,
                        resp: bool = True, term=None,
                        rng=None) -> np.ndarray:
        """(n_par, 2, n_t) simultaneous CIs via the max-|deviation|
        critical value (Ruppert et al. 2003; R/sde.R:1045-1180)."""
        from scipy.stats import norm

        rng = np.random.default_rng() if rng is None else rng
        X_fe, X_re = self._ci_design(t, new_data, X_fe, X_re)
        n_par = len(self._spec.params)
        n_t = X_fe.shape[0] // n_par

        par_lin = self.par(t="all", X_fe=X_fe, X_re=X_re, resp=False,
                           term=term)
        CI_pw = self.CI_pointwise(
            X_fe=X_fe, X_re=X_re, level=level, n_post=n_post,
            resp=False, term=term, rng=rng,
        )  # (n_par, 2, n_t)
        z = norm.ppf((1 + level) / 2)
        se_lin = (par_lin - CI_pw[:, 0, :].T) / z  # (n_t, n_par)

        post = self.post_coeff(n_post=n_post, rng=rng)
        diff_fe = post["coeff_fe"] - self._coeff_fe  # (n_post, p_fe)
        diff_re = post["coeff_re"] - (
            self._coeff_re if post["coeff_re"].shape[1] else 0.0
        )
        if term is not None:
            ti = self._term_cols(term)
            keep_fe = np.zeros(diff_fe.shape[1], bool)
            keep_fe[ti["fe"]] = True
            diff_fe = diff_fe * keep_fe
            if diff_re.shape[1]:
                keep_re = np.zeros(diff_re.shape[1], bool)
                keep_re[ti["re"]] = True
                diff_re = diff_re * keep_re

        sim_dev = X_fe @ diff_fe.T
        if diff_re.shape[1]:
            sim_dev = sim_dev + X_re @ diff_re.T  # (n_t*n_par, n_post)
        se_vec = se_lin.T.reshape(-1)  # column-major stacking
        with np.errstate(divide="ignore", invalid="ignore"):
            abs_dev = np.abs(sim_dev / se_vec[:, None])
        abs_dev[~np.isfinite(abs_dev)] = 0.0
        abs_dev = abs_dev.reshape(n_par, n_t, n_post)
        max_abs = abs_dev.max(axis=1)  # (n_par, n_post)
        crit = np.nanquantile(max_abs, level, axis=1)
        crit[~np.isfinite(crit)] = 0.0

        out = np.empty((n_par, 2, n_t))
        for i, p in enumerate(self._spec.params):
            inv = p.invlink if resp else (lambda x: x)
            out[i, 0] = np.asarray(inv(par_lin[:, i] - crit[i] * se_lin[:, i]))
            out[i, 1] = np.asarray(inv(par_lin[:, i] + crit[i] * se_lin[:, i]))
        return out

    # ------------------------------------------------------------------
    # Model checking and selection (R/sde.R:1182-1379)
    # ------------------------------------------------------------------

    def residuals(self) -> np.ndarray:
        """Normalized one-step-ahead residuals (n, m). BM, BM_t, OU: the
        closed-form transition residuals (R/sde.R:1186-1228). The
        state-space types: the whitened Kalman innovations
        chol(F)^-1 (y - Z a_pred), iid N(0, I) under the model, NaN where
        no measurement update happens (the reference errors out for
        them, R/sde.R:1221; the JAX package's extension)."""
        if self._spec.kind == "ssm":
            return self._residuals_ssm()
        n = self._data.n
        ids = self._ids
        breaks = np.where(ids[1:] != ids[:-1])[0]
        start = np.concatenate([[0], breaks + 1])
        end = np.concatenate([breaks, [n - 1]])
        is_start = np.zeros(n, bool)
        is_start[start] = True
        is_end = np.zeros(n, bool)
        is_end[end] = True

        dt = self._times[~is_start] - self._times[~is_end]
        mats = self.mats()
        par = self.par(t="all", X_fe=mats["X_fe"], X_re=mats["X_re"])
        Z = self._obs
        pnames = list(self._spec.param_names)
        n_dim = Z.shape[1]

        if self._type == "BM":
            mu = par[~is_end][:, :n_dim]
            mean = Z[~is_end] + mu * dt[:, None]
            sd = par[~is_end][:, n_dim][:, None] * np.sqrt(dt)[:, None]
        elif self._type == "BM_t":
            df = float(self._other_data["df"])
            mean = Z[~is_end] + par[~is_end][:, :1] * dt[:, None]
            sd = par[~is_end][:, 1][:, None] * np.sqrt(dt)[:, None]
            sd = sd / np.sqrt(df / (df - 2.0))
        elif self._type == "OU":
            mu = par[~is_end][:, :n_dim]
            tau = par[~is_end][:, pnames.index("tau")][:, None]
            kappa = par[~is_end][:, pnames.index("kappa")][:, None]
            e = np.exp(-dt[:, None] / tau)
            mean = mu + e * (Z[~is_end] - mu)
            sd = np.sqrt(kappa * (1.0 - e * e))
        else:
            raise NotImplementedError(
                f"Residuals not implemented for model {self._type}"
            )
        res = np.full((n, n_dim), np.nan)
        res[~is_start] = (Z[~is_start] - mean) / sd
        return res

    def _residuals_ssm(self) -> np.ndarray:
        """Whitened one-step-ahead innovations (see residuals)."""
        res = self.out()
        with torch.no_grad():
            u, F, ok = self.bundle().innovations(self._full(res.par,
                                                            res.bhat))
        u, F, ok = (a.to("cpu").numpy() for a in (u, F, ok))
        out = np.full(u.shape, np.nan)
        idx = np.where(ok)[0]
        if idx.size:
            L = np.linalg.cholesky(F[idx])
            out[idx] = np.linalg.solve(L, u[idx][..., None])[..., 0]
        return out

    def edf_conditional(self) -> float:
        """Fixed df + trace(H_re V_re) (R/sde.R:1356-1379), H the Hessian
        of the unpenalized joint nllk (torch.func.hessian through the
        forward-mode twin) at the estimates."""
        res = self.out()
        n_lambda_free = sum(1 for nm in res.par_names if nm == "log_lambda")
        edf = len(res.par) - n_lambda_free
        if res.joint_precision is not None:
            bundle = self.bundle()
            n_out = len(res.par)

            def joint_unpen(z):
                return bundle.joint_nllk_unpenalized(
                    bundle.packer.unpack(z[:n_out], z[n_out:]))

            z_hat = self._tensor(np.concatenate([res.par, res.bhat]))
            H = torch.func.hessian(joint_unpen)(z_hat)
            H = H.to("cpu", torch.float64).numpy()
            V = self.joint_cov()
            ind_re = np.where(np.array(res.joint_names) == "coeff_re")[0]
            H_re = H[np.ix_(ind_re, ind_re)]
            V_re = V[np.ix_(ind_re, ind_re)]
            edf = edf + float(np.trace(H_re @ V_re))
        return float(edf)

    def log_lik(self) -> float:
        """Joint unpenalized log-likelihood at the estimates
        (utility.R:115-123), on the bundle's value route: for a
        state-space model on a card a forward pass through the kernels."""
        res = self.out()
        full = self._full(res.par, res.bhat)
        with torch.no_grad():
            return float(self.bundle().loglik(full))

    def AIC_conditional(self) -> float:
        """-2 llk_joint + 2 edf (R/sde.R:1308-1328)."""
        return -2.0 * self.log_lik() + 2.0 * self.edf_conditional()

    def BIC(self) -> float:
        """Bayesian information criterion from the conditional
        log-likelihood and effective df (the reference reaches this via
        R's BIC generic on logLik.SDE, utility.R:115-123)."""
        return (
            -2.0 * self.log_lik()
            + np.log(self._data.n) * self.edf_conditional()
        )

    def AIC_marginal(self) -> float:
        """-2 llk_marg + 2 (n_outer - n_lambda) (R/sde.R:1330-1349)."""
        res = self.out()
        n_lambda_free = sum(1 for nm in res.par_names if nm == "log_lambda")
        edf = len(res.par) - n_lambda_free
        return 2.0 * res.value + 2.0 * edf

    def filtered_states(self) -> np.ndarray:
        """Kalman filtered state estimates (n, s) of a state-space model,
        the reference's REPORT(aest_all) (nllk_ctcrw.hpp:249,
        nllk_bm_ssm.hpp:177, nllk_ou_ssm.hpp:215): row i the state
        estimate after observation i (the prediction for i + 1, or a0 at
        a track start), at the fitted parameters. On a CUDA model they
        come from the parallel filter's filtered moments, on the CPU from
        the sequential scan (infer/objective.py `filter_states`)."""
        if self._spec.kind != "ssm":
            raise RuntimeError(
                "filtered_states is only available for state-space models"
            )
        res = self.out()
        with torch.no_grad():
            states = self.bundle().filter_states(self._full(res.par,
                                                            res.bhat))
        return states.to("cpu").numpy()

    def smoothed_states(self):
        """Smoothed (position, velocity) state distributions for CTCRW
        models at the fitted parameters, through the parallel RTS
        smoother (a capability beyond the reference, which only reports
        filtered states). Returns NumPy (means (d, n, 2), covs
        (d, n, 2, 2)). On a CUDA model the scans run on the phase-1
        kernel K8 (ops/scan_utils.py) and the cross-block prefix K2."""
        if self._type != "CTCRW":
            raise NotImplementedError(
                "smoothed_states is currently implemented for CTCRW"
            )
        if self._other_data.get("H") is not None:
            raise NotImplementedError(
                "smoothed_states requires isotropic observation noise"
            )
        from smoothsde_tpu_torch.ops.kalman_smooth import (
            ctcrw_smoothed_states,
        )

        res = self.out()
        bundle = self.bundle()
        with torch.no_grad():
            full = self._full(res.par, res.bhat)
            means, covs = ctcrw_smoothed_states(
                bundle.par_matrix(full), self._obs, self._times, self._ids,
                sigma_obs=torch.exp(full["log_sigma_obs"][0]),
            )
        return means.cpu().numpy(), covs.cpu().numpy()

    def check_post(self, check_fn, n_sims: int = 100, silent: bool = False,
                   rng=None):
        """Posterior predictive checks (R/sde.R:1230-1306). check_fn maps
        a data dict to a scalar or vector of statistics. Returns
        {"obs_stat", "stats", "fig"} (fig None without matplotlib)."""
        rng = np.random.default_rng() if rng is None else rng
        data_dict = {c: self._data.raw(c) for c in self._data.columns}
        obs_stat = np.atleast_1d(np.asarray(check_fn(data_dict), float))
        stats = np.zeros((len(obs_stat), n_sims))
        for s in range(n_sims):
            if not silent:
                print(f"Simulation {s + 1}/{n_sims}", end="\r")
            sim = self.simulate(data=data_dict, posterior=True, rng=rng)
            stats[:, s] = np.atleast_1d(np.asarray(check_fn(sim), float))
        fig = None
        try:
            import matplotlib

            matplotlib.use("Agg", force=False)
            import matplotlib.pyplot as plt

            k = len(obs_stat)
            fig, axes = plt.subplots(1, k, figsize=(4 * k, 3), squeeze=False)
            for i in range(k):
                ax = axes[0, i]
                ax.hist(stats[i], bins=20, density=True, color="lightgrey",
                        edgecolor="white")
                ax.axvline(obs_stat[i], color="black")
                ax.set_title(f"statistic {i + 1}")
            fig.suptitle("Vertical line is observed value")
            fig.tight_layout()
        except ImportError:
            pass
        return {"obs_stat": obs_stat, "stats": stats, "fig": fig}

    # ------------------------------------------------------------------
    # Simulation (R/sde.R:1381-1508)
    # ------------------------------------------------------------------

    def simulate(self, data=None, z0=0.0, posterior: bool = False, rng=None,
                 sigma_obs=None):
        """Simulate observations for the covariates in `data`
        (R/sde.R:1395-1508). Returns a dict/DataFrame copy with the
        response column(s) replaced by simulated paths. BM_SSM / OU_SSM
        (beyond the reference): latent path plus measurement noise;
        `sigma_obs` defaults to the fitted exp(log_sigma_obs)."""
        from smoothsde_tpu_torch.api.simulate import simulate_paths

        rng = np.random.default_rng() if rng is None else rng
        if data is None:
            data = {c: self._data.raw(c) for c in self._data.columns}
        cdata = data if isinstance(data, ColumnData) else ColumnData(data)
        if "time" not in cdata:
            raise ValueError("'data' should have a column named 'time'")
        if "ID" in cdata:
            _, ids = np.unique(cdata.raw("ID"), return_inverse=True)
        else:
            ids = np.zeros(cdata.n, int)
        times = cdata.numeric("time")

        if posterior:
            coeff = self.post_coeff(n_post=1, rng=rng)
            par = self.par(
                new_data=cdata,
                coeff_fe=coeff["coeff_fe"][0],
                coeff_re=(coeff["coeff_re"][0] if coeff["coeff_re"].shape[1]
                          else None),
            )
        else:
            par = self.par(new_data=cdata)

        n_dim = len(self._response)
        if sigma_obs is None and self._type in ("BM_SSM", "OU_SSM"):
            if self._fit_result is None:
                raise ValueError(
                    "simulating an unfitted SSM requires sigma_obs="
                )
            res = self.out()
            est = self.bundle().packer.split_estimates(res.par, res.bhat)
            sigma_obs = float(np.exp(est["log_sigma_obs"][0]))
        sims = simulate_paths(self._type, par, times, ids, n_dim, z0, rng,
                              sigma_obs=sigma_obs)
        out = dict(data) if isinstance(data, dict) else data.copy()
        for d, rname in enumerate(self._response):
            out[rname] = sims[:, d]
        return out

    # ------------------------------------------------------------------
    # Plotting (R/sde.R:1510-1644)
    # ------------------------------------------------------------------

    def plot_par(self, var, par_names=None, covs=None, n_post: int = 100,
                 show_CI: str = "none", resp: bool = True, term=None,
                 rng=None):
        """Covariate-grid parameter plot with posterior spaghetti or CI
        ribbons. Returns a matplotlib Figure (R/sde.R:1539-1644)."""
        from smoothsde_tpu_torch.api.plots import plot_par

        return plot_par(
            self, var, par_names=par_names, covs=covs, n_post=n_post,
            show_CI=show_CI, resp=resp, term=term, rng=rng,
        )

    # ------------------------------------------------------------------
    # Misc / printing (R/sde.R:1646-1795)
    # ------------------------------------------------------------------

    def ind_fixcoeff(self) -> np.ndarray:
        """Indices of fixed coefficients in coeff_fe (R/sde.R:1649-1673)."""
        out = []
        k = 0
        for j, pname in enumerate(self._spec.param_names):
            w = self._terms["ncol_fe"][j]
            if pname in self._fixpar:
                out.extend(range(k, k + w))
            k += w
        return np.array(out, int)

    def eqn(self) -> str:
        return model_eqn(self._type)

    def message(self):
        print("#######################")
        print("### smoothsde-tpu model ###")
        print("#######################")
        print(f"> SDE for {self._type} model:")
        print(self.eqn(), "\n")
        print("> Formulas for model parameters:")
        for pname, f in self._formulas.items():
            shown = "fixed" if pname in self._fixpar else f
            print(f"* {pname} ~ {shown.lstrip('~')}")
        print()

    def print_par(self):
        fitted = self._fit_result is not None
        label = "Estimated" if fitted else "Initial"
        print(f"> {label} SDE parameters (t = 0):")
        par = self.par(t=0)
        CI = self.CI_pointwise(t=0) if fitted else None
        for i, nm in enumerate(self._spec.param_names):
            msg = f"* {nm} = {par[0, i]:.3f}"
            if CI is not None:
                msg += f"\t ({CI[i, 0, 0]:.3f}, {CI[i, 1, 0]:.3f})"
            print(msg)

    def __repr__(self):
        return (
            f"SDE(type={self._type!r}, response={self._response}, "
            f"n={self._data.n}, fitted={self._fit_result is not None})"
        )

    def print(self):
        self.message()
        self.print_par()

    # ------------------------------------------------------------------
    # Checkpoint / resume: the JAX package's .npz keys, so a checkpoint
    # written by either package loads into the other
    # ------------------------------------------------------------------

    def save_state(self, path: str):
        """Save coefficient state + fit results to an .npz checkpoint."""
        payload = {
            "coeff_fe": self._coeff_fe,
            "coeff_re": self._coeff_re,
            "lambda": self._lambda,
            "rho": self._rho,
            "type": np.array(self._type),
            "response": np.array(self._response),
        }
        res = self._fit_result
        if res is not None:
            payload.update(
                fit_par=res.par,
                fit_par_names=np.array(res.par_names),
                fit_value=np.array(res.value),
                fit_convergence=np.array(res.convergence),
                fit_bhat=res.bhat,
                fit_inner_names=np.array(res.inner_names),
            )
            if res.H_marg is not None:
                payload["fit_H_marg"] = res.H_marg
            if res.joint_precision is not None:
                payload["fit_joint_precision"] = res.joint_precision
                payload["fit_joint_names"] = np.array(res.joint_names)
        np.savez(path, **payload)

    def load_state(self, path: str):
        """Restore a checkpoint written by save_state (of either package)
        into this model (built with the same formulas and data shapes)."""
        from smoothsde_tpu_torch.infer.fit import FitResult

        z = np.load(path, allow_pickle=False)
        if str(z["type"]) != self._type:
            raise ValueError(
                f"checkpoint is for type {z['type']}, model is {self._type}"
            )
        self._coeff_fe = np.asarray(z["coeff_fe"])
        self._coeff_re = np.asarray(z["coeff_re"])
        self._lambda = np.asarray(z["lambda"])
        self._rho = np.asarray(z["rho"])
        self._bundle = None
        if "fit_par" in z:
            bhat = np.asarray(z["fit_bhat"])
            self._fit_result = FitResult(
                par=np.asarray(z["fit_par"]),
                par_names=[str(s) for s in z["fit_par_names"]],
                value=float(z["fit_value"]),
                convergence=int(z["fit_convergence"]),
                counts={},
                systime=0.0,
                message="restored from checkpoint",
                bhat=bhat,
                # checkpoints from before REML carried only coeff_re in
                # the inner vector
                inner_names=(
                    [str(s) for s in z["fit_inner_names"]]
                    if "fit_inner_names" in z
                    else ["coeff_re"] * len(bhat)
                ),
                H_marg=(np.asarray(z["fit_H_marg"]) if "fit_H_marg" in z
                        else None),
                cov_fixed=(prec_to_cov(np.asarray(z["fit_H_marg"]))
                           if "fit_H_marg" in z else None),
                joint_precision=(np.asarray(z["fit_joint_precision"])
                                 if "fit_joint_precision" in z else None),
                joint_names=([str(s) for s in z["fit_joint_names"]]
                             if "fit_joint_names" in z else None),
            )
        return self

    def stationary(self):
        """Describe the stationary distribution (OU: normal, CIR: gamma),
        R/sde.R:1753-1795."""
        par = self.par(t=0)
        pnames = list(self._spec.param_names)
        msg = (
            f"Based on {'estimated' if self._fit_result else 'initial'} SDE "
            f"parameters (t = 0), the stationary distribution of this "
            f"{self._type} process is "
        )
        if self._type in ("OU", "OU_SSM"):
            mu = par[0, 0]
            kappa = par[0, pnames.index("kappa")]
            msg += (
                f"normal with parameters:\n\t* mean = {mu:.3f}\n"
                f"\t* variance = {kappa:.3f}"
            )
        elif self._type == "CIR":
            mu = par[0, 0]
            beta = par[0, pnames.index("beta")]
            sigma = par[0, pnames.index("sigma")]
            var = mu * sigma**2 / (2 * beta)
            msg += (
                f"gamma with parameters:\n\t* mean = {mu:.3f}\n"
                f"\t* variance = {var:.3f}"
            )
        else:
            msg += "not available for this model type."
        msg += (
            "\n(Note: this is *not* the stationary distribution if the "
            "parameters are time-varying)"
        )
        print(msg)
        return msg
