"""Outer optimization (host BFGS over the Laplace marginal) and the
sdreport equivalent (outer Hessian, joint precision of all parameters).

Port of the host-optimizer path of smoothsde_tpu/infer/fit.py
(fit_model with optimizer="scipy", and _sdreport in host mode). This
mirrors the reference's fit path (R/sde.R:683-720): optim(...,
method="BFGS") over fn/gr, here the Laplace marginal of
infer/laplace.py and its exact implicit-function gradient (the joint
nllk itself when there are no inner coefficients), then the outer
Hessian by central finite differences of the gradient (optimHess's
strategy) and its inverse as `cov_fixed`. With inner coefficients the
joint precision over (outer, inner) is assembled as

    Q = [[H_marg + J_tb J_bb^-1 J_bt,  J_tb],
         [J_bt,                        J_bb]]

from the Hessian J of the joint nllk's forward-mode-capable twin
(`joint_nllk_ad_flat`: torch.func.hessian cannot run through the
state-space kernels' reverse-only autograd.Functions), whose Schur
complement reproduces Cov(theta) = H_marg^-1 and whose conditional
b|theta precision is the joint curvature J_bb.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from smoothsde_tpu_torch.infer.laplace import make_laplace
from smoothsde_tpu_torch.utils.misc import prec_to_cov


@dataclasses.dataclass
class FitResult:
    par: np.ndarray  # outer (fixed-effect-level) estimates
    par_names: List[str]
    value: float  # marginal nllk at the optimum
    convergence: int
    counts: dict  # scipy's function/gradient counts + "evals" (val+grad)
    systime: float
    message: str
    bhat: np.ndarray  # inner (random-effect) estimates, free entries
    inner_names: List[str]
    H_marg: Optional[np.ndarray] = None
    cov_fixed: Optional[np.ndarray] = None
    joint_precision: Optional[np.ndarray] = None
    joint_names: Optional[List[str]] = None
    timings: Optional[dict] = None  # wall-clock per stage, seconds
    # which criterion earned convergence == 0: 'optimizer', 'gtol',
    # 'slope_probe', 'descent_probe', or 'none'
    convergence_via: str = "none"
    optimizer: str = "scipy"


def make_val_grad(bundle):
    """fn(x: np.ndarray, b0=None) -> (value, gradient, bhat) of the
    Laplace marginal at the outer vector x, from the inner warm start b0
    (the inner initial values when None), evaluated on the bundle's
    device and dtype (x is rounded to the working dtype first, as the
    JAX package's f32 path does). Without inner coefficients the value
    is the joint nllk and bhat is empty. The Laplace marginal is made
    once per bundle (`bundle.marginal`), so every evaluation of the
    bundle replays the same captured CUDA graphs."""
    packer = bundle.packer
    if bundle.marginal is None:  # one per bundle: its CUDA graphs too
        bundle.marginal = make_laplace(bundle.joint_nllk, packer,
                                       joint_nllk_ad=bundle.joint_nllk_ad,
                                       hess_plan=bundle.hess_plan)
    marginal = bundle.marginal
    b_init = packer.inner_init()

    def val_grad(x, b0=None):
        xt = torch.tensor(np.asarray(x, np.float64), dtype=bundle.dtype,
                          device=bundle.device, requires_grad=True)
        if not packer.n_inner:  # the joint nllk: no inner tensors at all
            v = bundle.joint_nllk(packer.unpack(xt))
            b = np.zeros(0)
        else:
            bt = torch.tensor(np.asarray(b_init if b0 is None else b0,
                                         np.float64),
                              dtype=bundle.dtype, device=bundle.device)
            v, b = marginal(xt, bt)
            b = b.to("cpu", torch.float64).numpy()
        (g,) = torch.autograd.grad(v, xt)
        return (float(v.detach()),
                g.detach().to("cpu", torch.float64).numpy(), b)

    return val_grad


def fit_model(
    bundle,
    method: str = "BFGS",
    maxiter: int = 1000,
    compute_sdreport: bool = True,
    fd_step: float = 1e-4,
    verbose: bool = False,
) -> FitResult:
    from scipy import optimize

    packer = bundle.packer
    raw_val_grad = make_val_grad(bundle)
    n_evals = 0

    def val_grad(x, b0=None):
        nonlocal n_evals
        n_evals += 1
        return raw_val_grad(x, b0)

    x0 = packer.outer_init()
    b_warm = packer.inner_init()
    timings = {}
    if len(x0) == 0:
        # everything is integrated out (e.g. REML with no free variance
        # parameters): a single marginal evaluation is the fit
        v, _, b = val_grad(x0, b_warm)
        return FitResult(
            par=np.zeros(0), par_names=[], value=v, convergence=0,
            counts={"function": 1, "gradient": 1, "evals": n_evals},
            systime=0.0, message="no outer parameters", bhat=b,
            inner_names=packer.inner_names(), convergence_via="optimizer",
        )
    cache = {}

    def eval_at(x):
        nonlocal b_warm
        key = np.asarray(x, float).tobytes()
        if key not in cache:
            v, g, b = val_grad(x, b_warm)
            if np.isfinite(v):
                b_warm = b  # warm start of the next inner solve
            cache.clear()
            cache[key] = (v, g, b)
        return cache[key]

    # scipy BFGS reports "precision loss" when the line search stalls at
    # the optimum; treat a small gradient as converged regardless. The
    # tolerance scales with the objective magnitude and dtype: f32
    # gradients carry relative noise ~1e-4 of |nllk|; in f64 the floor
    # is scipy's own default gtol.
    f32 = bundle.dtype == torch.float32
    eps = 1e-3 if f32 else 1e-6
    floor = 1e-3 if f32 else 1e-5

    def _gtol(v):
        return max(floor, eps * (1.0 + abs(v)))

    # Line-search-safe wrappers: replace non-finite values with a large
    # finite penalty (scipy's Wolfe search gives up on inf/nan).
    BIG = 1e10

    def safe_fun(x):
        v = eval_at(x)[0]
        return v if np.isfinite(v) else BIG

    def safe_jac(x):
        v, g, _ = eval_at(x)
        if not np.isfinite(v):
            return np.zeros_like(g)
        return np.where(np.isfinite(g), g, 0.0)

    t0 = time.time()
    total_nfev = total_njev = 0
    x_cur = x0
    # BFGS with restarts: a restart resets the Hessian approximation,
    # which recovers from stalled line searches far from the optimum.
    for _attempt in range(4):
        options = {"maxiter": maxiter, "disp": verbose}
        if method == "BFGS":
            options["gtol"] = _gtol(safe_fun(x_cur))
        res = optimize.minimize(
            fun=safe_fun, x0=x_cur, jac=safe_jac, method=method,
            options=options,
        )
        total_nfev += int(res.nfev)
        total_njev += int(getattr(res, "njev", 0))
        v_new, g_new, _ = eval_at(np.asarray(res.x, float))
        improved = v_new < safe_fun(x_cur) - 1e-10
        x_cur = np.asarray(res.x, float)
        if res.success or np.max(np.abs(g_new)) < _gtol(v_new) or not improved:
            break

    x_hat = x_cur
    v_hat, g_hat, b_hat = eval_at(x_hat)
    via = "none"
    if np.isfinite(v_hat):
        if bool(res.success):
            via = "optimizer"
        elif np.max(np.abs(g_hat)) < _gtol(v_hat):
            via = "gtol"
    if via == "none" and np.isfinite(v_hat):
        # The f32 gradient noise floor grows with the number of summed
        # likelihood terms, so decide empirically: (a) the central-
        # difference slope along the reported gradient must reproduce
        # |g|; else (b) no descent probe along -g may improve the value
        # beyond the dtype noise floor.
        gnorm = float(np.linalg.norm(g_hat))
        if gnorm > 0:
            u = np.asarray(g_hat) / gnorm
            h = 1e-2
            d = (safe_fun(x_hat + h * u) - safe_fun(x_hat - h * u)) / (2 * h)
            if abs(d) < 0.3 * gnorm:
                via = "slope_probe"
            else:
                noise = (1e-5 if f32 else 1e-10) * (1.0 + abs(v_hat))
                best = min(
                    safe_fun(x_hat - hh * u) for hh in (1e-3, 1e-2, 3e-2)
                )
                if v_hat - best <= noise:
                    via = "descent_probe"
    timings["optimize"] = time.time() - t0

    out = FitResult(
        par=x_hat,
        par_names=packer.outer_names(),
        value=v_hat,
        convergence=int(via == "none"),
        counts={"function": total_nfev, "gradient": total_njev},
        systime=timings["optimize"],
        message=str(res.message),
        bhat=b_hat,
        inner_names=packer.inner_names(),
        convergence_via=via,
    )
    if compute_sdreport:
        t1 = time.time()
        _sdreport(out, bundle, val_grad, fd_step)
        timings["sdreport"] = time.time() - t1
    out.counts["evals"] = n_evals
    out.timings = timings
    return out


def _sdreport(out, bundle, val_grad, fd_step):
    """Outer Hessian by central differences of the marginal's gradient,
    every inner solve warm-started at bhat (the reference's sdreport,
    R/sde.R:702-704), and with inner coefficients the joint precision;
    written onto `out`."""
    packer = bundle.packer
    x_hat = np.asarray(out.par, float)
    b_hat = np.asarray(out.bhat, float)
    n_out = len(x_hat)
    if not n_out:
        out.H_marg = np.zeros((0, 0))
        out.cov_fixed = np.zeros((0, 0))
    else:
        def fd_hessian(hs):
            G = np.stack([
                val_grad(x_hat + s * hs[i] * np.eye(n_out)[i], b_hat)[1]
                for s in (1.0, -1.0) for i in range(n_out)
            ])
            return (G[:n_out] - G[n_out:]) / (2.0 * hs[:, None])

        hs = fd_step * np.maximum(1.0, np.abs(x_hat))
        H = fd_hessian(hs)
        # a perturbed point can land in a non-finite region; retry the
        # offending coordinates with a 10x smaller step
        bad = ~np.isfinite(H).all(axis=1)
        if bad.any():
            H[bad] = fd_hessian(hs / 10.0)[bad]
        out.H_marg = 0.5 * (H + H.T)
        out.cov_fixed = prec_to_cov(out.H_marg)

    n_in = packer.n_inner
    if n_in == 0:
        return

    def joint_vec(z):
        return bundle.joint_nllk_ad_flat(packer.unpack(z[:n_out], z[n_out:]))

    z_hat = torch.tensor(np.concatenate([x_hat, b_hat]), dtype=bundle.dtype,
                         device=bundle.device)
    J = torch.func.hessian(joint_vec)(z_hat).to("cpu", torch.float64).numpy()
    J_tb = J[:n_out, n_out:]
    J_bb = J[n_out:, n_out:]
    top_left = out.H_marg + J_tb @ np.linalg.solve(J_bb, J_tb.T)
    Q = np.block([[top_left, J_tb], [J_tb.T, J_bb]])
    out.joint_precision = 0.5 * (Q + Q.T)
    out.joint_names = packer.outer_names() + packer.inner_names()
