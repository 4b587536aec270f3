"""The comparison that decides `correct`: a fit of the program against
the plain reference (`reference/<TYPE>.py`, or `reference/<config>.py`
where a configuration has its own), which works the likelihood out again
from the same data in float64.

The reference module gives the layout and the likelihood: `names(config)`
the fit's outer parameter names, `truth(config)` the simulators' truth as
an outer vector, and `nllk(config, theta, obs, dt, dtype)` at an outer
vector theta. A fit's answer is its outer vector theta, its nllk there,
and its precision P (the inverse of its covariance, cov_fixed). The
reference gives the nllk and its gradient by autograd, its Hessian H by
central differences of the gradient (steps 1e-4 max(1, |theta_i|), as
the program's sdreport), and its own optimum theta* by Newton steps
from the simulators' truth, with C* = H*^-1 and se* = sqrt(diag C*)
there. The numbers compared, each the worst over the fits checked:
  value_rel  |fit's nllk - reference's nllk at theta| / |reference's|:
             the objective (the kernels and the torch ops around them);
  est_se     max_i |theta_i - theta*_i| / se*_i: the estimates' distance
             from the reference's optimum in its standard errors (the
             optimizer);
  curv_rel   max |eig(L*' P L*) - 1| with C* = L* L*': the worst relative
             error of the fit's curvature along any direction, so of its
             variances (the sdreport); 1 or more where P is not positive
             definite (a non-finite standard error).
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("value_rel", "est_se", "curv_rel")


def value_grad(cell, theta, obs, dt, dtype=torch.float64):
    """The reference's nllk and its gradient at theta (float64 on the
    host), its filter in `dtype` (float64 for the reference, lower for
    the control)."""
    th = torch.tensor(theta, dtype=torch.float64, device=obs.device,
                      requires_grad=True)
    v = cell.reference.nllk(cell.config, th, obs, dt, dtype)
    (g,) = torch.autograd.grad(v, th)
    return float(v.detach()), g.cpu().numpy()


def fd_hessian(cell, theta, obs, dt, dtype=torch.float64):
    """Central differences of the gradient, symmetrized."""
    n = len(theta)
    hs = 1e-4 * np.maximum(1.0, np.abs(theta))
    rows = []
    for i in range(n):
        e = np.zeros(n)
        e[i] = hs[i]
        gp = value_grad(cell, theta + e, obs, dt, dtype)[1]
        gm = value_grad(cell, theta - e, obs, dt, dtype)[1]
        rows.append((gp - gm) / (2.0 * hs[i]))
    H = np.array(rows)
    return 0.5 * (H + H.T)


def optimum(cell, start, obs, dt, steps=12):
    """The reference's optimum theta* by Newton steps from `start` (near
    it), and its Hessian at the last step's start (the last step moves
    theta by under a thousandth of a standard error)."""
    theta = np.asarray(start, float)
    for _ in range(steps):
        g = value_grad(cell, theta, obs, dt)[1]
        H = fd_hessian(cell, theta, obs, dt)
        step = np.linalg.solve(H, g)
        theta = theta - step
        if np.all(np.abs(step) <= 1e-3 * np.sqrt(np.diag(np.linalg.inv(H)))):
            return theta, H
    raise RuntimeError(f"no reference optimum within {steps} Newton steps")


def tensors(obs, dt, device):
    return (torch.as_tensor(obs, dtype=torch.float64, device=device),
            torch.as_tensor(dt, dtype=torch.float64, device=device))


def compare(cell, rec, obs, dt, device):
    """The numbers compared for one fit `rec` (its value, par, prec and
    par_names) on the job's data obs (steps, tracks, D) and dt (steps,
    tracks)."""
    want = cell.reference.names(cell.config)
    if rec["names"] != want:
        raise ValueError(f"outer parameters {rec['names']}, the reference "
                         f"takes {want}")
    obs, dt = tensors(obs, dt, device)
    theta = np.asarray(rec["par"], float)
    v = value_grad(cell, theta, obs, dt)[0]
    star, H = optimum(cell, cell.reference.truth(cell.config), obs, dt)
    C = np.linalg.inv(H)
    L = np.linalg.cholesky(C)
    eig = np.linalg.eigvalsh(L.T @ np.asarray(rec["prec"], float) @ L)
    return {"value_rel": abs(rec["value"] - v) / abs(v),
            "est_se": float(np.max(np.abs(theta - star)
                                   / np.sqrt(np.diag(C)))),
            "curv_rel": float(np.max(np.abs(eig - 1.0)))}
