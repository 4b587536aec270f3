"""The SDE model class: user-facing API of the PyTorch port.

Port of smoothsde_tpu/api/sde.py for the ported slice (the state-space
models CTCRW, BM_SSM and OU_SSM): construction from formulas + data,
fitting by maximum likelihood (host BFGS over the kernel-backed nllk and
its Fisher-identity gradient), the outer covariance `cov_fixed`,
parameter evaluation with inverse links, and the smoothed states of a
fitted CTCRW.

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
    """Varying-coefficient SDE model (CTCRW / BM_SSM / OU_SSM slice of
    the port).

    Args:
      formulas: dict mapping SDE parameter names to formula strings
        (intercepts and linear/factor terms), in the model's parameter
        order. None = intercept-only for all.
      data: pandas DataFrame or dict of columns with a "time" column, the
        response column(s), covariates, and optionally "ID" (tracks).
      type: model type; the port runs "CTCRW" (parameters mu.., tau,
        nu), "BM_SSM" (mu.., sigma) and "OU_SSM" (mu.., tau, kappa), each
        with Gaussian measurement error of SD sigma_obs (fitted); other
        types raise NotImplementedError naming their ROADMAP.md item.
      response: response column name, or list of names (multivariate).
      par0: optional initial response-scale values, one per parameter
        (sequence in parameter order, or dict keyed by name).
      fixpar: names of SDE parameters fixed at their par0 value.
      other_data: model extras (user H / P0 are not ported yet).
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
        check_slice(self._spec, other_data=other_data)
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
        check_slice(self._spec, self._design, other_data)
        ncol_fe = list(self._design.ncol_fe)
        self._coeff_fe = np.zeros(sum(ncol_fe))
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
        self._other_data = dict(other_data or {})
        self._bundle = None
        self._fit_result = None

    def coeff_fe(self) -> np.ndarray:
        return self._coeff_fe.copy()

    def obs(self) -> np.ndarray:
        return self._obs.copy()

    # ------------------------------------------------------------------
    # Fitting
    # ------------------------------------------------------------------

    def setup(self, map=None):
        """Build the objective bundle (TMB MakeADFun equivalent) on this
        model's device and dtype."""
        from smoothsde_tpu_torch.infer.objective import build_objective

        self._bundle = build_objective(
            self._spec, self._design, self._obs, self._times, self._ids,
            other_data=self._other_data, fixpar=self._fixpar,
            init={"coeff_fe": self._coeff_fe}, map_fix=map,
            dtype=self._dtype, device=self._device,
        )
        return self._bundle

    def bundle(self):
        if self._bundle is None:
            self.setup()
        return self._bundle

    def fit(self, silent: bool = True, map=None, mesh=None,
            criterion: str = "ML", **kwargs):
        """Fit by maximum likelihood (R/sde.R:683-720); kwargs go to
        infer.fit.fit_model (method, maxiter, compute_sdreport, fd_step).
        """
        from smoothsde_tpu_torch.infer.fit import fit_model

        if mesh is not None:
            raise NotImplementedError(
                "sharded fits are outside the ported slice; see "
                "ROADMAP.md queue 1 item 10 (sharding)"
            )
        if criterion != "ML":
            raise NotImplementedError(
                "REML integrates coefficients out by the Laplace "
                "approximation; see ROADMAP.md queue 1 item 7"
            )
        if not silent:
            print(f"> SDE for {self._type} model on {self._device} "
                  f"({self._dtype})")
            for pname, f in self._formulas.items():
                shown = "fixed" if pname in self._fixpar else f
                print(f"* {pname} ~ {shown.lstrip('~')}")
        if self._bundle is None or map is not None:
            self.setup(map=map)
        res = fit_model(self._bundle, verbose=not silent, **kwargs)
        est = self._bundle.packer.split_estimates(res.par)
        self._coeff_fe = np.asarray(est["coeff_fe"])
        self._fit_result = res
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
        the response scale unless resp=False (R/sde.R:802-856)."""
        ev = self._design
        if new_data is not None:
            ev = ev.eval(new_data if isinstance(new_data, ColumnData)
                         else ColumnData(new_data))
        if t is None:
            t = "all" if new_data is not None else 0
        lp = np.asarray(ev.stacked_X_fe()) @ self._coeff_fe
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
