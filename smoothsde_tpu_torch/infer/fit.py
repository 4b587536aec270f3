"""Outer optimization (BFGS over the Laplace marginal) and the sdreport
equivalent (outer Hessian, joint precision of all parameters).

Port of smoothsde_tpu/infer/fit.py (fit_model and _sdreport). Two optimizers: "scipy", host BFGS with one host round trip per
evaluation, and "device", the L-BFGS of infer/lbfgs.py with its state on
the model's device, followed by the slope and descent probes and the
finite-difference outer Hessian, all on the device and read back in one
copy, then a short host BFGS polish where the JAX package runs one. The
"scipy" path mirrors the reference's fit path (R/sde.R:683-720): optim(...,
method="BFGS") over fn/gr, here the Laplace marginal of
infer/laplace.py and its exact implicit-function gradient (the joint
nllk itself when there are no inner coefficients), then the outer
Hessian by central finite differences of the gradient (optimHess's
strategy; `sdreport_mode`: a host loop, or the points stacked on the
device and read back in one copy, `fd_hessian`) and its inverse as
`cov_fixed`. `FitResult.timings` holds the JAX package's per-stage
summary (utils/profiling.StageTimer: marginal_nllk_grad,
outer_hessian_fd, joint_precision, device_lbfgs, device_polish) and the
port's own stages (`PORT_STAGES`): the build of the bundle, each
evaluation's enqueue, every read of the device ("host_read": its calls
are the fit's host reads) and each CUDA graph's capture (the device
optimizer's step, the Laplace layer's graphs); and `profile_dir` receives a torch.profiler trace of the optimization, the
stages in it as "stage.<name>" ranges. With
inner coefficients the
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

import contextlib
import dataclasses
import functools
import time
from typing import List, Optional

import numpy as np
import torch

from smoothsde_tpu_torch.infer.laplace import Graphed, make_laplace
from smoothsde_tpu_torch.utils.misc import prec_to_cov, to_device
from smoothsde_tpu_torch.utils.profiling import NO_TIMER, StageTimer, trace

OPTIMIZERS = ("scipy", "device", "auto")
SDREPORT_MODES = ("auto", "host", "device")
# the stages the port records beside the JAX package's: the build
# (SDE(...) and setup()), an evaluation's work up to its first read of
# the device, each read of the device, and a CUDA graph's capture and
# each of its replays
PORT_STAGES = ("build.columns", "build.design", "build.params",
               "build.rows", "eval.enqueue", "host_read", "graph.capture",
               "graph.replay")


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
    # per stage: {calls, first_s, steady_s, total_s} (StageTimer); the
    # "build.*" entries are the bundle's one-time build, repeated in
    # every fit of the bundle (a sum over fits counts it once a fit)
    timings: Optional[dict] = None
    # which criterion earned convergence == 0: 'optimizer', 'gtol',
    # 'slope_probe', 'descent_probe', or 'none'
    convergence_via: str = "none"
    # which optimizer ran ('scipy' or 'device'): what 'auto' resolved to
    optimizer: str = "scipy"
    # the device optimizer's steps (one evaluation and one host read
    # each) and how they ran: "graph", "eager", or why not a graph
    device_steps: int = 0
    device_graph: Optional[str] = None
    # how an evaluation without inner coefficients ran (the host loop's,
    # the FD Hessian's): "graph" (replayed from the bundle's CUDA graph)
    # or "eager (<why not>)"
    eval_graph: Optional[str] = None


def make_val_grad(bundle, timer=NO_TIMER):
    """fn(x: np.ndarray, b0=None) -> (value, gradient, bhat) of the
    Laplace marginal at the outer vector x, from the inner warm start b0
    (the inner initial values when None), evaluated on the bundle's
    device and dtype (x is rounded to the working dtype first, as the
    JAX package's f32 path does). Without inner coefficients the value
    is the joint nllk and bhat is empty. The Laplace marginal is made
    once per bundle (`bundle.marginal`), so every evaluation of the
    bundle replays the same captured CUDA graphs; so is, without inner
    coefficients, its value and gradient (`bundle.value_grad`: one CUDA
    graph on a card, `graph_refusal`). Each evaluation records
    in `timer` (a StageTimer) "eval.enqueue", the upload of x, the
    forward and the gradient, and a "host_read" around each read of the
    device: the value, the gradient and, with inner coefficients, bhat
    (the inner Newton's own reads are "host_read" stages inside the
    enqueue)."""
    packer = bundle.packer
    if bundle.marginal is None:  # one per bundle: its CUDA graphs too
        bundle.marginal = make_laplace(
            bundle.joint_nllk, packer, joint_nllk_ad=bundle.joint_nllk_ad,
            hess_plan=bundle.hess_plan,
            eager="collectives across processes"
            if _multi_process(bundle) else None)
        bundle.value_grad = Graphed(_joint_value_grad(bundle),
                                    graph_refusal(bundle))
    marginal = bundle.marginal
    b_init = packer.inner_init()

    def val_grad(x, b0=None):
        with timer.stage("eval.enqueue"):
            xt = to_device(x, bundle.dtype, bundle.device)
            if not packer.n_inner:  # the joint nllk: no inner tensors
                v, g = bundle.value_grad(xt, timer=timer)
                b = None
            else:
                xt.requires_grad_()
                bt = to_device(b_init if b0 is None else b0, bundle.dtype,
                               bundle.device)
                v, b = marginal(xt, bt, timer)
                (g,) = torch.autograd.grad(v, xt)
        with timer.stage("host_read"):
            v = float(v.detach())
        with timer.stage("host_read"):
            g = g.detach().to("cpu", torch.float64).numpy()
        if b is None:
            return v, g, np.zeros(0)
        with timer.stage("host_read"):
            b = b.to("cpu", torch.float64).numpy()
        return v, g, b

    return val_grad


def _joint_value_grad(bundle):
    """value_grad(x) -> (value, gradient) of the joint nllk at the outer
    tensor x, for a bundle without inner coefficients. It refers to the
    bundle's likelihood and packer, not to the bundle, which holds it."""
    joint, packer = bundle.joint_nllk, bundle.packer

    def value_grad(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            v = joint(packer.unpack(xg))
            (g,) = torch.autograd.grad(v, xg)
        return v.detach(), g

    return value_grad


def graph_refusal(bundle) -> Optional[str]:
    """Why the bundle's value and gradient (`make_val_grad`'s
    `bundle.value_grad`) may not be replayed from a CUDA graph, or None:
    inner coefficients (the inner Newton reads the device), a model off
    the card, or `_eager_reason`'s mesh. A capture that the stream
    refuses stays eager too (laplace.Graphed)."""
    if bundle.packer.n_inner:
        return "inner coefficients"
    if bundle.device.type != "cuda":
        return f"{bundle.device.type} device"
    return _eager_reason(bundle)


def _eval_graph(bundle) -> Optional[str]:
    """FitResult.eval_graph: how the bundle's evaluations ran; None where
    its `value_grad` has not run on the card yet."""
    return next(iter(bundle.value_grad.status.values()), None)


def _multi_process(bundle) -> bool:
    """The bundle's likelihood is summed across processes (a ("dcn",
    axis) mesh)."""
    mesh = getattr(bundle, "mesh", None)
    return mesh is not None and mesh.processes is not None


def _eager_reason(bundle) -> Optional[str]:
    """Why `device_lbfgs` may not capture its step, nor `make_val_grad`
    an evaluation, as a CUDA graph on this bundle, or None: collectives
    across the processes of a ("dcn", axis) mesh, or a mesh over more
    than one card."""
    mesh = getattr(bundle, "mesh", None)
    if mesh is None:
        return None
    if mesh.processes is not None:
        return f"collectives across {mesh.n_proc} processes"
    if mesh.n_cards > 1:
        return f"{mesh.n_cards} cards"
    return None


def resolve_optimizer(bundle) -> str:
    """optimizer="auto": "device" on a CUDA model for every closed-form
    model, for small models (n <= 5,000 steps and <= 64 inner
    coefficients) and for models without inner coefficients (config 5a),
    where the host round trip of each evaluation outweighs the
    evaluation; "scipy" otherwise: the JAX package's thresholds, with a
    CUDA device where it tests for a TPU, with or without a mesh."""
    small = bundle.n_obs <= 5000 and bundle.packer.n_inner <= 64
    no_inner = bundle.packer.n_inner == 0
    on_card = bundle.device.type == "cuda"
    return "device" if on_card and (
        bundle.kind == "closed_form" or small or no_inner) else "scipy"


def _agreed(val_grad, procs):
    """val_grad whose (value, gradient, bhat) are rank 0's on every rank
    (`collectives.first_rank`): a host loop over it (scipy's) takes the
    same steps on every rank."""
    from smoothsde_tpu_torch.parallel.collectives import first_rank

    def vg(x, b0=None):
        v, g, b = val_grad(x, b0)
        flat = first_rank(torch.from_numpy(np.concatenate([[v], g, b])),
                          procs).numpy()
        return float(flat[0]), flat[1:1 + len(g)], flat[1 + len(g):]

    return vg


def _scipy_objective(val_grad, b_warm, timer=None):
    """scipy's view of val_grad: (at, fun, jac). `at(x)` -> (value,
    gradient, bhat) with a one-entry cache, each inner solve warm-started
    at the last finite point's bhat (b_warm first), each evaluation a
    "marginal_nllk_grad" stage of `timer`; `fun` and `jac` are
    line-search-safe: a non-finite value becomes 1e10 and its gradient 0,
    a non-finite gradient entry 0 (scipy's Wolfe search gives up on inf
    and nan)."""
    cache = {}

    def at(x):
        nonlocal b_warm
        key = np.asarray(x, float).tobytes()
        if key not in cache:
            with (timer.stage("marginal_nllk_grad") if timer is not None
                  else contextlib.nullcontext()):
                v, g, b = val_grad(x, b_warm)
            if np.isfinite(v):
                b_warm = b  # warm start of the next inner solve
            cache.clear()
            cache[key] = (v, g, b)
        return cache[key]

    def fun(x):
        v = at(x)[0]
        return v if np.isfinite(v) else 1e10

    def jac(x):
        v, g, _ = at(x)
        if not np.isfinite(v):
            return np.zeros_like(g)
        return np.where(np.isfinite(g), g, 0.0)

    return at, fun, jac


def fit_model(
    bundle,
    method: str = "BFGS",
    maxiter: int = 1000,
    compute_sdreport: bool = True,
    fd_step: float = 1e-4,
    verbose: bool = False,
    profile_dir: Optional[str] = None,
    optimizer: str = "scipy",
    sdreport_mode: str = "auto",
) -> FitResult:
    """optimizer: "scipy" (host BFGS over the device's value and
    gradient, the reference's optim(BFGS), R/sde.R:694-697), "device"
    (infer/lbfgs.py: one scalar read per step; the val+grad step is a
    CUDA graph without inner coefficients), or "auto"
    (`resolve_optimizer`). "device" on a mesh over more than one card or
    more than one process runs its steps eagerly (`device_graph` says
    why), and across processes every rank reads the same flag and the
    same copy of the result, so the ranks stop together. profile_dir: a
    torch.profiler trace of the optimization is written there
    (utils/profiling.trace). The result's `timings` carry the bundle's
    build stages ("build.*", calls 1) beside the fit's own: the one-time
    build of `SDE(...)` and `setup()`, repeated in every fit of the
    bundle, not work this fit ran.
    sdreport_mode: how the outer Hessian's FD gradients run, "host" (one
    evaluation and host read each), "device" (`fd_hessian`: stacked on
    the device, one copy back) or "auto" ("device" on a CUDA model,
    "host" otherwise: the JAX package's rule, with a card where it tests
    for a TPU)."""
    from scipy import optimize

    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {OPTIMIZERS}")
    if sdreport_mode not in SDREPORT_MODES:
        raise ValueError(f"sdreport_mode must be one of {SDREPORT_MODES}")
    if optimizer == "auto":
        optimizer = resolve_optimizer(bundle)
    timer = StageTimer()
    if bundle.build_timer is not None:
        timer.merge(bundle.build_timer)
    packer = bundle.packer
    raw_val_grad = make_val_grad(bundle, timer)
    n_evals = 0

    def val_grad(x, b0=None):
        nonlocal n_evals
        n_evals += 1
        return raw_val_grad(x, b0)

    x0 = packer.outer_init()
    b_warm = packer.inner_init()
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

    if optimizer == "device":
        return _fit_device(bundle, val_grad, maxiter, compute_sdreport,
                           fd_step, _gtol, lambda: n_evals, timer,
                           profile_dir, sdreport_mode)

    eval_at, safe_fun, safe_jac = _scipy_objective(val_grad, b_warm, timer)

    t0 = time.time()
    total_nfev = total_njev = 0
    x_cur = x0
    with trace(profile_dir):
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
            if (res.success or np.max(np.abs(g_new)) < _gtol(v_new)
                    or not improved):
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

    out = FitResult(
        par=x_hat,
        par_names=packer.outer_names(),
        value=v_hat,
        convergence=int(via == "none"),
        counts={"function": total_nfev, "gradient": total_njev},
        systime=time.time() - t0,
        message=str(res.message),
        bhat=b_hat,
        inner_names=packer.inner_names(),
        convergence_via=via,
    )
    if compute_sdreport:
        _sdreport(out, bundle, val_grad, fd_step, timer, sdreport_mode)
    out.counts["evals"] = n_evals
    out.eval_graph = _eval_graph(bundle)
    out.timings = timer.summary()
    return out


def fd_hessian(grad_at, x, fd_step):
    """The outer Hessian by central differences of grad_at (a tensor ->
    its gradient tensor) on x's device: the 4 n points x +- h e_i and
    x +- h e_i / 10 (h = fd_step max(1, |x_i|)) in one stack, each row
    of the h sweep with a non-finite entry taken from the h / 10 sweep (a
    perturbed point can land in a non-finite region). (n, n), not
    symmetrized, on the device: the caller reads it back in one copy."""
    n = x.shape[0]
    hs = fd_step * torch.clamp(x.abs(), min=1.0)
    dh = torch.diag(hs)
    pts = torch.cat([x + dh, x - dh, x + dh / 10, x - dh / 10])
    G = torch.stack([grad_at(p) for p in pts])
    H1 = (G[:n] - G[n:2 * n]) / (2.0 * hs[:, None])
    H2 = (G[2 * n:3 * n] - G[3 * n:]) / (2.0 * (hs / 10.0)[:, None])
    bad = ~torch.isfinite(H1).all(dim=1, keepdim=True)
    return torch.where(bad, H2, H1)


def _marginal_grad(bundle, b, timer):
    """grad_at(xp): the marginal's gradient at xp, its inner solve from
    b; without inner coefficients `bundle.value_grad`'s, a replay of its
    CUDA graph where it has one."""
    if not bundle.packer.n_inner:
        return lambda xp: bundle.value_grad(xp, timer=timer)[1]
    marginal = functools.partial(bundle.marginal, timer=timer)

    def grad_at(xp):
        with torch.enable_grad():
            xg = xp.detach().requires_grad_(True)
            return torch.autograd.grad(marginal(xg, b)[0], xg)[0]

    return grad_at


def _fit_device(bundle, val_grad, maxiter, compute_sdreport, fd_step,
                gtol, host_evals, timer, profile_dir, sdreport_mode):
    """fit_model's "device" path (infer/fit.py:188-308 of the JAX
    package): the L-BFGS loop, then on the device the slope probe, the
    descent probes and the FD outer Hessian (`fd_hessian`), read back in
    one copy; then the terminal host polish where the JAX package runs
    one (inner coefficients, or no convergence) and the sdreport. On a
    ("dcn", axis) mesh the loop's flags are OR-ed over the ranks, and the
    copy and every polish evaluation are rank 0's on every rank, so
    every rank makes the same evaluations in the same order."""
    from scipy import optimize

    from smoothsde_tpu_torch.infer.lbfgs import device_lbfgs
    from smoothsde_tpu_torch.parallel.collectives import first_rank

    packer = bundle.packer
    # made by make_val_grad; its reads of the device are this fit's
    marginal = functools.partial(bundle.marginal, timer=timer)
    procs = bundle.mesh.processes if _multi_process(bundle) else None
    if procs is not None:
        val_grad = _agreed(val_grad, procs)
    dtype, device = bundle.dtype, bundle.device
    f32 = dtype == torch.float32
    n_out = packer.n_outer

    def tensor(a):
        return to_device(a, dtype, device)

    t0 = time.time()
    with timer.stage("device_lbfgs"), trace(profile_dir):
        r = device_lbfgs(marginal, tensor(packer.outer_init()),
                         tensor(packer.inner_init()), maxiter=maxiter,
                         eager=_eager_reason(bundle), processes=procs,
                         timer=timer)

        def value_at(xp):
            return marginal(xp, r.b)[0].detach()

        # The convergence probes (the scipy path's, with its constants):
        # the central-difference slope along g must reproduce |g|, or no
        # descent step along -g may improve on the noise floor.
        with torch.no_grad():
            gnorm = torch.linalg.vector_norm(r.g)
            u = r.g / torch.clamp(gnorm, min=1e-30)
            h = 1e-2
            slope = (value_at(r.x + h * u) - value_at(r.x - h * u)) / (2 * h)
            slope_ok = slope.abs() < 0.3 * gnorm
            noise = (1e-5 if f32 else 1e-10) * (1.0 + r.f.abs())
            best = torch.minimum(torch.minimum(value_at(r.x - 1e-3 * u),
                                               value_at(r.x - 1e-2 * u)),
                                 value_at(r.x - 3e-2 * u))
            descent_ok = (r.f - best) <= noise
        fuse_fd = compute_sdreport and n_out > 0
        H_fd = torch.zeros(0, dtype=dtype, device=device)
        if fuse_fd:
            H_fd = fd_hessian(_marginal_grad(bundle, r.b, timer), r.x,
                              fd_step).reshape(-1)
        # everything the host needs, in one copy
        n_in = r.b.shape[0]
        head = torch.stack([r.f, r.n_iter.to(dtype), r.n_evals.to(dtype),
                            r.converged.to(dtype), slope_ok.to(dtype),
                            descent_ok.to(dtype)])
        with timer.stage("host_read"):
            vals = torch.cat([head, r.x, r.b, H_fd]).to("cpu",
                                                        torch.float64)
        if procs is not None:
            vals = first_rank(vals, procs)
        vals = vals.numpy()
    f_hat, n_iter, n_evals, conv, s_ok, d_ok = vals[:6]
    x_hat = vals[6:6 + n_out]
    b_hat = vals[6 + n_out:6 + n_out + n_in]
    H = vals[6 + n_out + n_in:].reshape(n_out, n_out) if fuse_fd else None
    via = ("optimizer" if conv else "slope_probe" if s_ok
           else "descent_probe" if d_ok else "none")
    n_iter, n_evals = int(n_iter), int(n_evals)
    out = FitResult(
        par=np.array(x_hat), par_names=packer.outer_names(),
        value=float(f_hat), convergence=int(via == "none"),
        counts={"function": n_evals + 5, "gradient": n_iter + 1,
                "evals": n_evals + (4 * n_out if fuse_fd else 0),
                "iterations": n_iter, "device_evals": n_evals},
        systime=0.0, message=f"device L-BFGS: {n_iter} iterations",
        bhat=np.array(b_hat), inner_names=packer.inner_names(),
        convergence_via=via, optimizer="device", device_steps=r.steps,
        device_graph=r.graph)
    evals0 = host_evals()
    if packer.n_inner > 0 or via == "none":
        # the terminal host polish: a few BFGS iterations from the device
        # iterate, the first inner solve warm-started at its bhat (the
        # JAX package starts every one there)
        with timer.stage("device_polish"):
            pol_at, pol_fun, pol_jac = _scipy_objective(val_grad, b_hat)
            pol = optimize.minimize(
                fun=pol_fun, x0=out.par, jac=pol_jac, method="BFGS",
                options={"maxiter": 25, "gtol": gtol(out.value)})
        out.counts["function"] += int(pol.nfev)
        out.counts["gradient"] += int(getattr(pol, "njev", 0))
        moved = float(pol.fun) < out.value - 1e-7 * (1.0 + abs(out.value))
        if np.isfinite(pol.fun) and float(pol.fun) <= out.value:
            if moved:
                # the inner solve at the polished point, so bhat matches
                # par; the device's FD Hessian is stale there
                out.bhat = pol_at(pol.x)[2]
                H = None
            out.par = np.asarray(pol.x, float)
            out.value = float(pol.fun)
            if pol.success:
                out.convergence = 0
                out.convergence_via = "optimizer"
    out.systime = time.time() - t0
    if compute_sdreport:
        _sdreport(out, bundle, val_grad, fd_step, timer, sdreport_mode,
                  H_precomputed=H)
    out.counts["evals"] += host_evals() - evals0
    out.eval_graph = _eval_graph(bundle)
    out.timings = timer.summary()
    return out


def _sdreport(out, bundle, val_grad, fd_step, timer, mode="auto",
              H_precomputed=None):
    """Outer Hessian by central differences of the marginal's gradient,
    every inner solve warm-started at bhat (the reference's sdreport,
    R/sde.R:702-704), unless the device path's finite `H_precomputed`
    is given, and with inner coefficients the joint precision; written
    onto `out`. mode (fit_model's sdreport_mode): "host" evaluates the
    2 n_out points one by one (and the offending rows again at a 10x
    smaller step), "device" runs `fd_hessian` on the model's device,
    "auto" picks "device" on a CUDA model."""
    packer = bundle.packer
    x_hat = np.asarray(out.par, float)
    b_hat = np.asarray(out.bhat, float)
    n_out = len(x_hat)
    if mode == "auto":
        mode = "device" if bundle.device.type == "cuda" else "host"
    H = H_precomputed
    if not n_out:
        out.H_marg = np.zeros((0, 0))
        out.cov_fixed = np.zeros((0, 0))
    else:
        if H is None or not np.isfinite(H).all():
            with timer.stage("outer_hessian_fd"):
                H = (_fd_device(bundle, x_hat, b_hat, fd_step, timer)
                     if mode == "device"
                     else _fd_host(val_grad, x_hat, b_hat, fd_step))
        out.H_marg = 0.5 * (H + H.T)
        out.cov_fixed = prec_to_cov(out.H_marg)

    n_in = packer.n_inner
    if n_in == 0:
        return

    def joint_vec(z):
        return bundle.joint_nllk_ad_flat(packer.unpack(z[:n_out], z[n_out:]))

    z_hat = to_device(np.concatenate([x_hat, b_hat]), bundle.dtype,
                      bundle.device)
    with timer.stage("joint_precision"):
        J = torch.func.hessian(joint_vec)(z_hat)
        with timer.stage("host_read"):
            J = J.to("cpu", torch.float64).numpy()
    J_tb = J[:n_out, n_out:]
    J_bb = J[n_out:, n_out:]
    top_left = out.H_marg + J_tb @ np.linalg.solve(J_bb, J_tb.T)
    Q = np.block([[top_left, J_tb], [J_tb.T, J_bb]])
    out.joint_precision = 0.5 * (Q + Q.T)
    out.joint_names = packer.outer_names() + packer.inner_names()


def _fd_host(val_grad, x_hat, b_hat, fd_step):
    """The FD outer Hessian by a host loop over val_grad."""
    n_out = len(x_hat)

    def sweep(hs):
        G = np.stack([
            val_grad(x_hat + s * hs[i] * np.eye(n_out)[i], b_hat)[1]
            for s in (1.0, -1.0) for i in range(n_out)
        ])
        return (G[:n_out] - G[n_out:]) / (2.0 * hs[:, None])

    hs = fd_step * np.maximum(1.0, np.abs(x_hat))
    H = sweep(hs)
    # a perturbed point can land in a non-finite region; retry the
    # offending coordinates with a 10x smaller step
    bad = ~np.isfinite(H).all(axis=1)
    if bad.any():
        H[bad] = sweep(hs / 10.0)[bad]
    return H


def _fd_device(bundle, x_hat, b_hat, fd_step, timer):
    """The FD outer Hessian by `fd_hessian` on the model's device, the
    inner solves from bhat, in one copy back (a "host_read" of
    `timer`)."""
    def tensor(a):
        return to_device(a, bundle.dtype, bundle.device)

    grad_at = _marginal_grad(bundle, tensor(b_hat), timer)
    H = fd_hessian(grad_at, tensor(x_hat), fd_step)
    with timer.stage("host_read"):
        return H.to("cpu", torch.float64).numpy()
