"""Laplace approximation over smooth / random-effect coefficients.

Port of smoothsde_tpu/infer/laplace.py. Replaces TMB's
MakeADFun(random = "coeff_re") machinery (R/sde.R:656-658): the marginal
nllk over the outer parameters theta is

    marg(theta) = joint(theta, bhat) + 1/2 log det H_bb(theta, bhat)
                  - k/2 log(2 pi),
    bhat(theta) = argmin_b joint(theta, b),

with bhat computed by a damped Newton solver (a host loop; the seven
step sizes of each line search are one vmapped evaluation) and
differentiated by the implicit function theorem (an autograd.Function:
d bhat/d theta = -H_bb^{-1} d^2 joint / db dtheta). Autograd through
`marginal_nllk` is then the exact gradient of the Laplace objective,
the curvature (log-det) term included: H_bb is torch.func.jacfwd of
torch.func.grad, and reverse mode runs through both.

The joint objective must be plain tensor arithmetic that torch.func can
transform (vmap, jvp, grad); the kernels' reverse-only
autograd.Functions cannot serve here.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.func import grad, jacfwd, vjp, vmap

# The inner Newton's limits (the JAX package's LaplaceConfig defaults):
# iterations, the f64 gradient tolerance, the relative ridge on H.
_MAX_ITER = 100
_TOL = 1e-8
_RIDGE = 1e-9

# 0.0 included: when every step size increases the objective (or lands
# on non-finite values), the iterate stays put instead of argmin
# picking an arbitrary bad candidate.
_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.0)


def make_laplace(joint_nllk: Callable, packer):
    """Build marginal_nllk(outer, b0) -> (value, bhat) for a packed
    objective: differentiable in `outer` (a tensor); b0 is the inner warm
    start (treated as a constant). Without inner coefficients the
    marginal is the joint nllk and bhat is empty."""
    n_inner = packer.n_inner
    if n_inner == 0:
        def marginal_trivial(outer, b0):
            return joint_nllk(packer.unpack(outer)), outer.new_zeros(0)

        return marginal_trivial

    def f(outer, b):
        return joint_nllk(packer.unpack(outer, b))

    grad_b = grad(f, argnums=1)
    hess_b = jacfwd(grad_b, argnums=1)
    f_batch = vmap(f, in_dims=(None, 0))

    def newton(outer, b0):
        outer = outer.detach()
        b = b0.detach()
        f64 = b.dtype == torch.float64
        # Absolute gradient tolerance, plus a scale-aware Newton
        # decrement criterion: g' H^-1 g has the units of the objective,
        # so comparing the achieved decrease against eps * (1 + |f|)
        # stops as soon as the dtype's achievable accuracy is reached (in
        # f32 a fixed small gradient tolerance is often unreachable).
        tol = _TOL if f64 else 1e-4
        eps_dec = 1e-12 if f64 else 1e-6
        alphas = torch.tensor(_ALPHAS, dtype=b.dtype, device=b.device)
        eye = torch.eye(n_inner, dtype=b.dtype, device=b.device)
        f_cur = f(outer, b)
        dec_tol = eps_dec * (1.0 + abs(float(f_cur)))
        g = grad_b(outer, b)
        progress = math.inf
        for _ in range(_MAX_ITER):
            if not (float(g.abs().max()) > tol and progress > dec_tol):
                break
            H = hess_b(outer, b)
            scale = H.diagonal().abs().mean() + 1.0
            delta = torch.linalg.solve(H + _RIDGE * scale * eye, g)
            cand = b[None, :] - alphas[:, None] * delta[None, :]
            fs = f_batch(outer, cand)
            fs = torch.where(torch.isfinite(fs), fs, math.inf)
            k = torch.argmin(fs)
            b = cand[k]
            f_new = torch.minimum(fs[k], f_cur)
            # Actual decrease achieved this iteration: when the line
            # search stalls (alpha = 0 wins, f32 noise floor reached),
            # stop instead of spinning to max_iter.
            progress = float(f_cur - f_new)
            f_cur = f_new
            g = grad_b(outer, b)
        return b

    class _Bhat(torch.autograd.Function):
        """bhat(outer) with the implicit-function gradient: the backward
        solves H w = v and returns minus the vector-Jacobian product of
        grad_b in `outer` with w."""

        @staticmethod
        def forward(ctx, outer, b0):
            b = newton(outer, b0)
            ctx.save_for_backward(outer.detach(), b)
            return b

        @staticmethod
        def backward(ctx, v):
            outer, b = ctx.saved_tensors
            H = hess_b(outer, b)
            w = torch.linalg.solve(H, v)
            _, vjp_fn = vjp(lambda o: grad_b(o, b), outer)
            (gout,) = vjp_fn(w)
            return -gout, None

    log_2pi = math.log(2.0 * math.pi)

    def marginal_nllk(outer, b0):
        b = _Bhat.apply(outer, b0)
        H = hess_b(outer, b)
        _, logdet = torch.linalg.slogdet(H)
        val = f(outer, b) + 0.5 * logdet - 0.5 * n_inner * log_2pi
        return val, b.detach()

    return marginal_nllk
