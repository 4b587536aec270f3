"""The SDE model class: user-facing API of the PyTorch port.

Port of smoothsde_tpu/api/sde.py for the ported slice: construction
from formulas + data, fitting by marginal maximum likelihood (host BFGS),
the outer covariance `cov_fixed`, parameter evaluation with inverse
links, and the smoothed states of a fitted CTCRW. Every ported type
takes smooths and random effects, integrated out by the Laplace
approximation (infer/laplace.py), and REML; the closed-form models (BM,
BM_t, OU, CIR) also decay-modulated splines. The state-space models
(CTCRW, BM_SSM, OU_SSM) run their likelihood on the hand-written
kernels and the Laplace layer's second-order quantities on a
forward-mode twin (infer/objective.py `loglik_ad`).

The device and the working type are explicit: `device="cuda"` (the
default) runs the hand-written CUDA kernels, `device="cpu"` their plain
PyTorch versions; a CUDA request without a card raises. `dtype` is
float32 by default (as the JAX package on the TPU) or float64.
Indices are 0-based (`t=0` is the first row).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from smoothsde_tpu_torch.formula.design import ColumnData, build_design
from smoothsde_tpu_torch.formula.parser import parse_formula
from smoothsde_tpu_torch.infer.objective import check_slice, resolve_device
from smoothsde_tpu_torch.models.registry import get_model_spec


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
        sigma_obs (fitted); other types raise NotImplementedError naming
        their ROADMAP.md item.
      response: response column name, or list of names (multivariate).
      par0: optional initial response-scale values, one per parameter
        (sequence in parameter order, or dict keyed by name).
      fixpar: names of SDE parameters fixed at their par0 value.
      other_data: model extras: "df" (BM_t); "t_decay" with "col_decay"
        (or "decay_term") and "ind_decay" for decay-modulated splines of
        the closed-form models (R/sde.R:163-181); user H / P0 are not
        ported yet.
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

        cdata = ColumnData(data)
        for r in responses:
            if r not in cdata:
                raise ValueError("'response' not found in 'data'")

        self._spec = get_model_spec(type, len(responses))
        check_slice(self._spec, other_data)
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
                raise ValueError("formulas should be ~1 for fixed parameters")
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
        self._ids = np.array([lvl_index[v] for v in cdata.raw("ID").tolist()])
        self._times = cdata.numeric("time")
        self._obs = np.column_stack([cdata.numeric(r) for r in responses])

        self._knots = dict(knots or {})
        self._design = build_design(self._formulas, cdata, knots=self._knots)
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
                        f"'par0' dict must have exactly one entry per SDE "
                        f"parameter ({', '.join(param_names)}); missing: "
                        f"{missing or 'none'}, unknown: {extra or 'none'}"
                    )
                par0 = [par0[p] for p in param_names]
            if len(par0) != len(param_names):
                raise ValueError(
                    f"'par0' should be of length {len(param_names)} with "
                    f"one entry for each SDE parameter "
                    f"({', '.join(param_names)})"
                )
            i0 = np.concatenate([[0], np.cumsum(ncol_fe)[:-1]]).astype(int)
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

    # ------------------------------------------------------------------
    # Accessors (R/sde.R:184-326)
    # ------------------------------------------------------------------

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

    def obs(self) -> np.ndarray:
        return self._obs.copy()

    # ------------------------------------------------------------------
    # Fitting
    # ------------------------------------------------------------------

    def setup(self, map=None, reml: bool = False):
        """Build the objective bundle (TMB MakeADFun equivalent) on this
        model's device and dtype, initialized at the current
        coefficients, smoothing parameters and decay rates."""
        from smoothsde_tpu_torch.infer.objective import build_objective

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
        self._reml = reml
        self._bundle = build_objective(
            self._spec, self._design, self._obs, self._times, self._ids,
            other_data=self._other_data, fixpar=self._fixpar,
            init=init, map_fix=map, reml=reml,
            dtype=self._dtype, device=self._device,
        )
        return self._bundle

    def bundle(self):
        if self._bundle is None:
            self.setup()
        return self._bundle

    def fit(self, silent: bool = True, map=None, mesh=None,
            criterion: str = "ML", **kwargs):
        """Fit by marginal maximum likelihood (R/sde.R:683-720); kwargs
        go to infer.fit.fit_model (method, maxiter, compute_sdreport,
        fd_step).

        `criterion`: "ML" (the reference's criterion) or "REML": the
        fixed-effect coefficients are integrated out alongside the smooth
        coefficients (TMB's random=c("coeff_fe", "coeff_re") REML
        construction)."""
        from smoothsde_tpu_torch.infer.fit import fit_model
        from smoothsde_tpu_torch.infer.objective import unported

        if mesh is not None:
            raise unported("a sharded fit", "sharding")
        if criterion not in ("ML", "REML"):
            raise ValueError("criterion must be 'ML' or 'REML'")
        reml = criterion == "REML"
        if not silent:
            print(f"> SDE for {self._type} model on {self._device} "
                  f"({self._dtype})")
            for pname, f in self._formulas.items():
                shown = "fixed" if pname in self._fixpar else f
                print(f"* {pname} ~ {shown.lstrip('~')}")
        if self._bundle is None or map is not None or self._reml != reml:
            self.setup(map=map, reml=reml)
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

    def out(self):
        """The result of the last fit()."""
        if self._fit_result is None:
            raise RuntimeError("Fit model first")
        return self._fit_result

    # ------------------------------------------------------------------
    # States
    # ------------------------------------------------------------------

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
            full = bundle.packer.unpack(torch.as_tensor(
                res.par, dtype=bundle.dtype, device=bundle.device))
            means, covs = ctcrw_smoothed_states(
                bundle.par_matrix(full), self._obs, self._times, self._ids,
                sigma_obs=torch.exp(full["log_sigma_obs"][0]),
            )
        return means.cpu().numpy(), covs.cpu().numpy()

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def par(self, t=None, new_data=None, resp: bool = True) -> np.ndarray:
        """(n_t, n_par) SDE parameters at rows `t` ("all", an index or
        indices; 0 by default, every row of `new_data` when given), on
        the response scale unless resp=False (R/sde.R:802-856). The
        linear predictor is X_fe coeff_fe + X_re coeff_re; on the model's
        own rows the decay-modulated columns are scaled by
        exp(-rho t_decay) (R/sde.R:303-326; `t_decay` belongs to those
        rows, so `new_data` rows take the columns unscaled)."""
        ev = self._design
        if new_data is not None:
            ev = ev.eval(new_data if isinstance(new_data, ColumnData)
                         else ColumnData(new_data))
        if t is None:
            t = "all" if new_data is not None else 0
        lp = np.asarray(ev.stacked_X_fe()) @ self._coeff_fe
        if len(self._coeff_re):
            X_re = np.array(ev.stacked_X_re(), float)
            if new_data is None and self._other_data.get("t_decay") is not None:
                t_decay = np.asarray(self._other_data["t_decay"],
                                     float).reshape(-1)
                for c, ind in zip(
                        np.atleast_1d(self._other_data["col_decay"]),
                        np.atleast_1d(self._other_data["ind_decay"])):
                    X_re[:, int(c) - 1] *= np.exp(
                        -self._rho[int(ind) - 1] * t_decay)
            lp = lp + X_re @ self._coeff_re
        lp = lp.reshape(len(self._spec.params), -1).T  # (n, n_par)
        if not (isinstance(t, str) and t == "all"):
            t_idx = np.atleast_1d(np.asarray(t, int))
            if np.any((t_idx < 0) | (t_idx >= lp.shape[0])):
                raise ValueError(
                    f"Elements of 't' should be between 0 and "
                    f"{lp.shape[0] - 1}"
                )
            lp = lp[t_idx]
        if not resp:
            return lp
        return np.column_stack([
            np.asarray(p.invlink(lp[:, i]))
            for i, p in enumerate(self._spec.params)
        ])
