"""Laplace approximation over smooth / random-effect coefficients.

Port of smoothsde_tpu/infer/laplace.py. Replaces TMB's
MakeADFun(random = "coeff_re") machinery (R/sde.R:656-658): the marginal
nllk over the outer parameters theta is

    marg(theta) = joint(theta, bhat) + 1/2 log det H_bb(theta, bhat)
                  - k/2 log(2 pi),
    bhat(theta) = argmin_b joint(theta, b),

with bhat computed by a damped Newton solver (a host loop; the seven
step sizes of each line search are one vmapped evaluation) and
differentiated by the implicit function theorem, d bhat/d theta =
-H_bb^{-1} d^2 joint / db dtheta. The gradient is assembled from its
parts, the quantity the JAX package's autograd produces:

    d marg/d theta = d_theta joint + g_theta
                     + (d bhat/d theta)' (d_b joint + g_b),
    (g_theta, g_b) = d/d(theta, b) of 1/2 tr(W H_bb(theta, b)),
                     W = H_bb^{-1} held fixed,

the last being the log-det term's partials (d log det H = tr(H^{-1}
dH)). `marginal_nllk` is an autograd.Function that returns it, so
autograd through the marginal is the exact gradient of the Laplace
objective.

Every second-order quantity runs through `joint_nllk_ad`, plain tensor
arithmetic that torch.func transforms (vmap, jvp, grad): the inner
Newton's value, gradient, Hessian and line search, the log-det partials
and the cross derivatives. `joint_nllk` carries only the value term
`joint(theta, bhat)` and its reverse-mode partials, so it may run on the
reverse-only kernel cores of the state-space models (their
autograd.Functions cannot be forward-differentiated). Without a twin the
two are the same function (the closed-form models). With a `hess_plan`
(infer/coloring.py) H_bb is the colored Hessian: one jvp per color
instead of one per coefficient.

On a CUDA device each twin quantity (the Hessian, the gradient, the
line search's batch, the log-det partials and cross derivatives) is
captured once as a CUDA graph and replayed: at a few thousand steps the
twin is thousands of small launches, and their host cost, not the card,
sets the time (PERF.md §5). A capture is used only when its replay
reproduces the eager result exactly; otherwise the function stays eager.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.func import grad, grad_and_value, jacfwd, vmap

from smoothsde_tpu_torch.utils.misc import to_device
from smoothsde_tpu_torch.utils.profiling import NO_TIMER

# The inner Newton's limits (the JAX package's LaplaceConfig defaults):
# iterations, the f64 gradient tolerance, the relative ridge on H.
_MAX_ITER = 100
_TOL = 1e-8
_RIDGE = 1e-9

# 0.0 included: when every step size increases the objective (or lands
# on non-finite values), the iterate stays put instead of argmin
# picking an arbitrary bad candidate.
_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.0)


def _solve(A, B):
    """torch.linalg.solve without its raise: a singular A gives NaN, as
    the JAX package's jnp.linalg.solve gives non-finite values, which the
    fit's line search reads as a non-finite objective."""
    X, info = torch.linalg.solve_ex(A, B)
    return torch.where(info == 0, X, math.nan)


def _equal(a, b, timer) -> bool:
    """torch.equal, a "host_read" stage of `timer` where it reads the
    device (an empty tensor reads nothing)."""
    if not a.numel():
        return torch.equal(a, b)
    with timer.stage("host_read"):
        return torch.equal(a, b)


class Graphed:
    """fn(*tensors) -> tensor or tuple of tensors, replayed from a CUDA
    graph captured at the first call with each (shape, dtype, device) of
    its arguments; CPU arguments run fn as it is. A capture that the
    stream refuses (a host sync or copy inside fn), or whose replay
    differs from the eager result on the same inputs, leaves that
    signature eager (`status` records which); any other error, an
    out-of-memory included, propagates. Outputs are fresh tensors.
    `eager`: a reason to run fn as it is, never captured (fn exchanges
    data with other processes, which a replay cannot). A call's `timer`
    (a StageTimer) records each capture (the warm-up run, the capture,
    the replay check) as a "graph.capture" stage, and the replay check's
    reads as "host_read" stages."""

    def __init__(self, fn, eager: Optional[str] = None):
        self.fn = fn
        self.entries = {}
        self.status = {} if eager is None else {"all": f"eager ({eager})"}
        self.eager = eager

    def __call__(self, *args, timer=NO_TIMER):
        if not args[0].is_cuda or self.eager is not None:
            return self.fn(*args)
        key = tuple((a.shape, a.dtype, a.device) for a in args)
        if key not in self.entries:
            with timer.stage("graph.capture"):
                self.entries[key] = self._capture(args, timer)
        entry = self.entries[key]
        if entry is None:
            return self.fn(*args)
        graph, static_in, static_out = entry
        for s, a in zip(static_in, args):
            s.copy_(a)
        graph.replay()
        return tuple(o.clone() for o in static_out) if isinstance(
            static_out, tuple) else static_out.clone()

    def _capture(self, args, timer):
        static_in = [a.detach().clone() for a in args]
        side = torch.cuda.Stream(args[0].device)
        side.wait_stream(torch.cuda.current_stream(args[0].device))
        with torch.cuda.stream(side):
            want = self.fn(*static_in)  # warm-up outside the capture
        torch.cuda.current_stream(args[0].device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                static_out = self.fn(*static_in)
        except torch.OutOfMemoryError:
            raise
        except RuntimeError as err:  # the stream refused the capture
            self.status[str(args[0].dtype)] = f"eager ({err})"[:200]
            return None
        graph.replay()
        outs = static_out if isinstance(static_out, tuple) else (static_out,)
        wants = want if isinstance(want, tuple) else (want,)
        same = all(_equal(o, w, timer) for o, w in zip(outs, wants))
        self.status[str(args[0].dtype)] = "graph" if same else \
            "eager (replay differs)"
        return (graph, static_in, static_out) if same else None


def make_laplace(joint_nllk: Callable, packer,
                 joint_nllk_ad: Optional[Callable] = None,
                 hess_plan: Optional[dict] = None,
                 eager: Optional[str] = None):
    """Build marginal_nllk(outer, b0, timer=NO_TIMER) -> (value, bhat)
    for a packed objective: differentiable in `outer` (a tensor); b0 is
    the inner warm start (treated as a constant); `timer` (a StageTimer)
    records the inner Newton's reads of the device as "host_read"
    stages. Without inner coefficients the
    marginal is the joint nllk and bhat is empty. `joint_nllk_ad`: the
    forward-mode-capable twin of `joint_nllk` (the same function), which
    carries every second-order quantity; `hess_plan`: a
    `plan_coloring` plan for H_bb; `eager`: a reason to capture no CUDA
    graph (a likelihood summed across processes). `marginal_nllk.graphs`
    lists the twin's graphed functions (their `status` says which were
    captured)."""
    n_inner = packer.n_inner
    if n_inner == 0:
        def marginal_trivial(outer, b0, timer=NO_TIMER):
            return joint_nllk(packer.unpack(outer)), outer.new_zeros(0)

        marginal_trivial.graphs = {}
        return marginal_trivial

    def f(outer, b):
        return joint_nllk(packer.unpack(outer, b))

    if joint_nllk_ad is None or joint_nllk_ad is joint_nllk:
        f_ad = f
    else:
        def f_ad(outer, b):
            return joint_nllk_ad(packer.unpack(outer, b))

    grad_b = grad(f_ad, argnums=1)
    if hess_plan is not None:
        from smoothsde_tpu_torch.infer.coloring import colored_hessian

        hess_b = colored_hessian(grad_b, hess_plan)
    else:
        hess_b = jacfwd(grad_b, argnums=1)

    def value_grad_b(outer, b):
        g, v = grad_and_value(f_ad, argnums=1)(outer, b)
        return v, g

    def tail(outer, b, W):
        """The cross derivatives d grad_b/d outer (k, n_outer) and the
        log-det partials in (outer, b), at (outer, b) with W = H_bb^{-1}
        fixed. Both in forward mode over `grad_b`: a reverse pass over
        H_bb would run through operations that the autograd engine
        recorded on its CUDA device thread, and the engine orders those
        among the caller's by per-thread sequence numbers, so the order
        in which it sums their contributions, and with it the partials'
        rounding, would follow the process's history (PERF.md §6)."""
        cross = jacfwd(grad_b, argnums=0)(outer, b)
        half_W = 0.5 * W  # no Python float times a 0-d tensor under jvp
        g_o, g_b = jacfwd(lambda o, bb: (half_W * hess_b(o, bb)).sum(),
                          argnums=(0, 1))(outer, b)
        return cross, g_o, g_b

    graphs = {
        "hess": Graphed(hess_b, eager),
        "value_grad": Graphed(value_grad_b, eager),
        "batch": Graphed(vmap(f_ad, in_dims=(None, 0)), eager),
        "tail": Graphed(tail, eager),
    }

    def newton(outer, b0, timer):
        b = b0.detach()
        f64 = b.dtype == torch.float64
        # Absolute gradient tolerance, plus a scale-aware Newton
        # decrement criterion: g' H^-1 g has the units of the objective,
        # so comparing the achieved decrease against eps * (1 + |f|)
        # stops as soon as the dtype's achievable accuracy is reached (in
        # f32 a fixed small gradient tolerance is often unreachable).
        tol = _TOL if f64 else 1e-4
        eps_dec = 1e-12 if f64 else 1e-6
        alphas = to_device(_ALPHAS, b.dtype, b.device)
        eye = torch.eye(n_inner, dtype=b.dtype, device=b.device)
        f_cur, g = graphs["value_grad"](outer, b, timer=timer)
        with timer.stage("host_read"):
            dec_tol = eps_dec * (1.0 + abs(float(f_cur)))
        progress = math.inf
        for _ in range(_MAX_ITER):
            with timer.stage("host_read"):
                g_max = float(g.abs().max())
            if not (g_max > tol and progress > dec_tol):
                break
            H = graphs["hess"](outer, b, timer=timer)
            scale = H.diagonal().abs().mean() + 1.0
            delta = _solve(H + _RIDGE * scale * eye, g)
            cand = b[None, :] - alphas[:, None] * delta[None, :]
            fs = graphs["batch"](outer, cand, timer=timer)
            fs = torch.where(torch.isfinite(fs), fs, math.inf)
            k = torch.argmin(fs)
            # indexing by a device scalar reads it
            with timer.stage("host_read"):
                b = cand[k]
            with timer.stage("host_read"):
                f_k = fs[k]
            f_new = torch.minimum(f_k, f_cur)
            # Actual decrease achieved this iteration: when the line
            # search stalls (alpha = 0 wins, f32 noise floor reached),
            # stop instead of spinning to max_iter.
            with timer.stage("host_read"):
                progress = float(f_cur - f_new)
            f_cur = f_new
            _, g = graphs["value_grad"](outer, b, timer=timer)
        return b

    log_2pi = math.log(2.0 * math.pi)

    class _Marginal(torch.autograd.Function):
        """(value, bhat) at outer; the backward returns the assembled
        gradient (module docstring) times the value's cotangent."""

        @staticmethod
        def forward(ctx, outer, b0, timer):
            outer = outer.detach()
            b = newton(outer, b0, timer)
            H = graphs["hess"](outer, b, timer=timer)
            _, logdet = torch.linalg.slogdet(H)
            W = _solve(H, torch.eye(n_inner, dtype=H.dtype,
                                    device=H.device))
            cross, g_o, g_b = graphs["tail"](outer, b, W, timer=timer)
            with torch.enable_grad():
                o = outer.clone().requires_grad_(True)
                bb = b.clone().requires_grad_(True)
                v = f(o, bb)
                d_o, d_b = torch.autograd.grad(v, (o, bb))
            dbhat = -_solve(H, cross)  # d bhat / d outer, (k, n_outer)
            ctx.save_for_backward(d_o + g_o + dbhat.T @ (d_b + g_b))
            ctx.mark_non_differentiable(b)
            val = v.detach() + 0.5 * logdet - 0.5 * n_inner * log_2pi
            return val, b

        @staticmethod
        def backward(ctx, gv, _gb):
            (gradient,) = ctx.saved_tensors
            return gv * gradient, None, None

    def marginal_nllk(outer, b0, timer=NO_TIMER):
        return _Marginal.apply(outer, b0, timer)

    marginal_nllk.graphs = graphs
    return marginal_nllk
