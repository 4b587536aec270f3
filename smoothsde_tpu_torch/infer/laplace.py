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
from typing import Callable, NamedTuple, Optional

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


# the integer type of each float width: == on a float's bits
_INT_OF_WIDTH = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    """t as integers of its width where it is a float: == on them is
    equality bit for bit (NaN equals NaN, -0 differs from 0)."""
    return t.view(_INT_OF_WIDTH[t.element_size()]) \
        if t.is_floating_point() else t


# one capture stream per card, made at its first capture
_CAPTURE_STREAMS = {}
# the last graph captured on each card. Every capture there shares its
# memory pool, which so outlives the Graphed objects that die with their
# bundles: a new capture takes the blocks their graphs freed, not new
# device memory. Sharing is sound here because a graph reads only its
# inputs, copied in before each replay, and what it wrote earlier in the
# same replay, and its outputs are copied out right after it.
_LAST_GRAPHS = {}
# graphs whose capture the stream refused. The allocators keep a filter
# that refers to each (torch does not undo a capture that failed), so
# each is kept alive, and its pool is shared no more.
_REFUSED = []


def _capture_stream(device):
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class _Entry(NamedTuple):
    """A captured signature: the graph, the tensors it reads and writes,
    and the kernel launches (ops/ctcrw_fused.LAUNCHES) one replay runs."""

    graph: object  # torch.cuda.CUDAGraph
    static_in: list
    static_out: object
    launches: dict


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
    the replay check) as a "graph.capture" stage, the check's one read
    as a "host_read" stage, and each replay as a "graph.replay" stage.
    A replay adds the kernel launches that its capture recorded to
    ops/ctcrw_fused.LAUNCHES, which so counts the kernels that ran.

    The capture is bare: no garbage collection, no release of the
    allocator's cache and no wait for the whole device before it (what
    torch.cuda.graph adds), only its stream ordered after the caller's.
    Its memory comes from a pool that every capture on the card shares
    (`_record`). The graph and the pool's blocks that it holds are freed
    with the Graphed, by reference counting, so `fn` must not refer to
    what holds the Graphed."""

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
        with timer.stage("graph.replay"):
            for s, a in zip(entry.static_in, args):
                s.copy_(a)
            _replay(entry)
            out = entry.static_out
            return tuple(o.clone() for o in out) if isinstance(
                out, tuple) else out.clone()

    def _capture(self, args, timer):
        device = args[0].device
        static_in = [a.detach().clone() for a in args]
        stream = _capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            want = self.fn(*static_in)  # warm-up outside the capture
            try:
                entry = _record(self.fn, static_in)
            except torch.OutOfMemoryError:
                raise
            except RuntimeError as err:  # the stream refused the capture
                entry = None
                self.status[str(args[0].dtype)] = f"eager ({err})"[:200]
        torch.cuda.current_stream(device).wait_stream(stream)
        if entry is None:
            return None
        _replay(entry)
        outs, wants = (o if isinstance(o, tuple) else (o,)
                       for o in (entry.static_out, want))
        same = all(o.shape == w.shape and o.dtype == w.dtype
                   for o, w in zip(outs, wants))
        if same:  # every output's bits against the warm-up's, one read
            flag = torch.stack([(_bits(o) == _bits(w)).all()
                                for o, w in zip(outs, wants)]).all()
            with timer.stage("host_read"):
                same = bool(flag)
        self.status[str(args[0].dtype)] = "graph" if same else \
            "eager (replay differs)"
        return entry if same else None


def _record(fn, static_in) -> _Entry:
    """fn(*static_in) captured on the current stream into a new graph, in
    the card's shared pool (`_LAST_GRAPHS`). The kernel launches counted
    while capturing did not run: they are taken off LAUNCHES again and
    kept for the replays."""
    from smoothsde_tpu_torch.ops.ctcrw_fused import LAUNCHES

    device = static_in[0].device
    last = _LAST_GRAPHS.get(device)
    pool = torch.cuda.graph_pool_handle() if last is None else last.pool()
    graph = torch.cuda.CUDAGraph()
    before = dict(LAUNCHES)
    graph.capture_begin(pool=pool)
    try:
        static_out = fn(*static_in)
    finally:
        try:
            graph.capture_end()
        except RuntimeError:  # refused: later captures take a new pool
            _REFUSED.append(graph)
            _LAST_GRAPHS.pop(device, None)
            end = getattr(torch._C, "_cuda_endAllocateToPool", None)
            if end is not None:  # the device allocator's filter
                end(device.index, pool)
            raise
        finally:
            launches = {k: v - before[k] for k, v in LAUNCHES.items()
                        if v != before[k]}
            LAUNCHES.update(before)
    _LAST_GRAPHS[device] = graph
    return _Entry(graph, static_in, static_out, launches)


def _replay(entry: _Entry):
    from smoothsde_tpu_torch.ops.ctcrw_fused import LAUNCHES

    entry.graph.replay()
    for name, n in entry.launches.items():
        LAUNCHES[name] += n


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
