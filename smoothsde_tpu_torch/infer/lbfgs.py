"""L-BFGS over the Laplace marginal with its state on the model's device.

Port of smoothsde_tpu/infer/lbfgs.py. The JAX package runs the whole
outer optimization inside one jitted lax.while_loop; here the loop is a
Python loop whose state (iterate, value, gradient, inner warm start,
the (s, y) ring buffer and the line search's trial) lives in tensors on
the model's device, and every step reads one scalar from the device:
the flag that says whether another step follows. A step is one
evaluation of the marginal's value and gradient followed by the
optimizer's update, written with torch.where so that no branch needs
the host: it either advances the line search to its next trial or
closes the iteration (accept, curvature pair, stall test, the
convergence test, the next direction). The steps evaluate the same
points in the same order as the JAX package's nested while loops.

Where the marginal's value and gradient need no host sync (no inner
coefficients: the joint nllk, configs 1 and 5a) on a CUDA device, the
step is captured once as a CUDA graph and replayed (infer/laplace.Graphed:
kept only when its replay equals the eager step bit for bit); the Laplace
marginal's inner Newton reads the device and runs eagerly, and so does a
step whose caller gives a reason (`eager`): a likelihood summed across
processes (a collective cannot run inside a graph) or sharded over
several cards. On a ("dcn", axis) mesh every process runs this loop; each
step's flag is the OR of every rank's (`processes`), read in one
collective, so no rank leaves the loop while another waits in a sum.

Algorithm (the JAX package's): limited-memory BFGS (two-loop recursion
over a ring buffer of m (s, y) pairs, gamma scaling, 1/||g|| before the
first pair), a sequential parabolic-backtracking Armijo line search of
at most _MAX_LS trials that keeps the best trial seen, curvature pairs
only when s'y > 0, the memory dropped after a stalled iteration and a
stop after two in a row, and the gradient tolerance
max(gtol_abs, gtol_rel (1 + |f|)).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_MAX_LS = 12  # backtracking trials per iteration (alpha >= ~2e-4)
_C1 = 1e-4  # Armijo constant
_BIG = 1e10  # the value a non-finite evaluation is replaced by


class LBFGSResult(NamedTuple):
    """The optimum as tensors on the device (read them in one copy), and
    what the loop did on the host."""

    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor  # inner (Laplace) coefficients at the optimum
    n_iter: torch.Tensor
    n_evals: torch.Tensor
    converged: torch.Tensor
    steps: int  # steps taken: one evaluation and one host read each
    graph: str  # how the steps ran: "graph", "eager", or why not a graph


# The state a step reads and writes, in this order: the iterate and its
# value, gradient and inner warm start; the memory; the counters; the
# direction and the line search (the next trial's step size, the trials
# made, and the best trial seen).
_FIELDS = ("x", "f", "g", "b", "S", "Y", "rho", "head", "k", "evals",
           "stall", "d", "dg", "alpha", "tries", "bf", "ba", "bg", "bb")


def _val_grad(marginal):
    """vg(x, b) -> (value, gradient, bhat): a non-finite value becomes
    _BIG (and keeps the warm start b), non-finite gradient entries 0."""

    def vg(x, b):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            v, b_new = marginal(xg, b)
            (g,) = torch.autograd.grad(v, xg)
        v = v.detach()
        ok = torch.isfinite(v)
        return (torch.where(ok, v, _BIG),
                torch.where(torch.isfinite(g), g, 0.0),
                torch.where(ok, b_new.detach(), b))

    return vg


def device_lbfgs(marginal, x0, b0, m: int = 10, maxiter: int = 200,
                 gtol_abs: float = 1e-3, gtol_rel: float = None,
                 eager: Optional[str] = None, processes=None
                 ) -> LBFGSResult:
    """Minimize marginal(x, b_warm) -> (value, bhat) from x0 with the
    inner warm start b0 (tensors on the model's device, one dtype).

    marginal: differentiable in x (infer.laplace.make_laplace's, or the
      joint nllk when there are no inner coefficients); b_warm is carried
      from the last accepted point, as the host loop does. With no inner
      coefficients (b0 empty) and no `eager` reason it must be free of
      host syncs: on a CUDA device each step is then replayed from a CUDA
      graph.
    eager: a reason to run every step as it is, never captured (the
      marginal exchanges data with other processes, or its work spans
      several cards); `graph` then reads "eager (<reason>)".
    processes: the parallel.collectives.Processes of a ("dcn", axis)
      mesh whose ranks all run this loop: the flag read after each step
      (and at the start) is the OR over the ranks.
    """
    x0 = x0.detach()
    dtype, device = x0.dtype, x0.device
    n = x0.shape[0]
    f32 = dtype == torch.float32
    if gtol_rel is None:
        gtol_rel = 1e-4 if f32 else 1e-6
    eps_dec = 1e-7 if f32 else 1e-12
    vg = _val_grad(marginal)
    slots = torch.arange(m, device=device)

    def gtol(f):
        return torch.clamp(gtol_rel * (1.0 + f.abs()), min=gtol_abs)

    def go_on(k, f, g, stall):
        return (k < maxiter) & (g.abs().max() > gtol(f)) & (stall < 2)

    def direction(g, S, Y, rho, head):
        """-H g by the two-loop recursion (newest pair first), steepest
        descent when that is not a finite descent direction."""
        order = (head - 1 - slots) % m  # newest -> oldest
        Sr, Yr, rr = S[order], Y[order], rho[order]
        q, a = g, []
        for i in range(m):
            ai = torch.where(rr[i] > 0, rr[i] * (Sr[i] @ q), 0.0)
            q = q - ai * Yr[i]
            a.append(ai)
        sy, yy = Sr[0] @ Yr[0], Yr[0] @ Yr[0]
        gamma0 = 1.0 / torch.clamp(torch.linalg.vector_norm(g), min=1.0)
        gamma = torch.where((rr[0] > 0) & (yy > 0), sy / yy, gamma0)
        r = gamma * q
        for i in reversed(range(m)):
            beta = torch.where(rr[i] > 0, rr[i] * (Yr[i] @ r), 0.0)
            r = r + (a[i] - beta) * Sr[i]
        d = -r
        dg = d @ g
        bad = ~torch.isfinite(d).all() | (dg >= 0)
        return (torch.where(bad, -g, d), torch.where(bad, -(g @ g), dg))

    def step(*state):
        st = dict(zip(_FIELDS, state))
        x, f, g, b, d, dg, alpha = (st[k] for k in
                                    ("x", "f", "g", "b", "d", "dg", "alpha"))
        # the trial at x + alpha d, warm-started from the iterate's bhat
        ft, gt, bt = vg(x + alpha * d, b)
        tries = st["tries"] + 1
        better = ft < st["bf"]
        bf = torch.where(better, ft, st["bf"])
        ba = torch.where(better, alpha, st["ba"])
        bg = torch.where(better, gt, st["bg"])
        bb = torch.where(better, bt, st["bb"])
        armijo = ft <= f + _C1 * alpha * dg
        search = (~armijo) & (tries < _MAX_LS) & (alpha > 2e-4)
        # the line search's next trial: the parabola's minimizer through
        # (0, f), (0, dg), (alpha, ft), clipped to [0.1, 0.5] alpha
        denom = 2.0 * (ft - f - dg * alpha)
        a_new = torch.where(denom > 0, -dg * alpha * alpha / denom,
                            0.5 * alpha)
        a_new = torch.minimum(torch.maximum(a_new, 0.1 * alpha), 0.5 * alpha)

        # the iteration closed: the Armijo point, else the best trial if
        # it improves, else stay put
        a_acc = torch.where(armijo, alpha, ba)
        f_acc = torch.where(armijo, ft, bf)
        take = armijo | (bf < f)
        x_new = torch.where(take, x + a_acc * d, x)
        f_new = torch.where(take, f_acc, f)
        g_new = torch.where(take, torch.where(armijo, gt, bg), g)
        b_new = torch.where(take, torch.where(armijo, bt, bb), b)
        s, y = x_new - x, g_new - g
        sy = s @ y
        ok_pair = sy > 1e-10 * (torch.linalg.vector_norm(s)
                                * torch.linalg.vector_norm(y) + 1e-30)
        put = (slots == st["head"]) & ok_pair
        S = torch.where(put[:, None], s, st["S"])
        Y = torch.where(put[:, None], y, st["Y"])
        rho = torch.where(put, 1.0 / sy, st["rho"])
        head = torch.where(ok_pair, (st["head"] + 1) % m, st["head"])
        stalled = (f - f_new) <= eps_dec * (1.0 + f.abs())
        rho = torch.where(stalled, torch.zeros_like(rho), rho)
        k = st["k"] + 1
        evals = st["evals"] + tries
        stall = torch.where(stalled, st["stall"] + 1, 0)
        more = go_on(k, f_new, g_new, stall)
        d_new, dg_new = direction(g_new, S, Y, rho, head)

        def pick(searching, closed):
            return torch.where(search, searching, closed)

        new = {
            "x": pick(x, x_new), "f": pick(f, f_new), "g": pick(g, g_new),
            "b": pick(b, b_new), "S": pick(st["S"], S),
            "Y": pick(st["Y"], Y), "rho": pick(st["rho"], rho),
            "head": pick(st["head"], head), "k": pick(st["k"], k),
            "evals": pick(st["evals"], evals),
            "stall": pick(st["stall"], stall), "d": pick(d, d_new),
            "dg": pick(dg, dg_new),
            "alpha": pick(a_new, torch.ones_like(alpha)),
            "tries": pick(tries, torch.zeros_like(tries)),
            # a new iteration's first trial is always its best so far
            "bf": pick(bf, torch.full_like(bf, math.inf)),
            "ba": ba, "bg": bg, "bb": bb,
        }
        return tuple(new[k] for k in _FIELDS) + (search | more,)

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    b0 = b0.detach().to(dtype=dtype, device=device)
    f0, g0, b0 = vg(x0, b0)
    zero = torch.zeros((), dtype=dtype, device=device)
    S0 = torch.zeros((m, n), dtype=dtype, device=device)
    rho0 = torch.zeros(m, dtype=dtype, device=device)
    head0 = i64(0)
    d0, dg0 = direction(g0, S0, S0, rho0, head0)
    state = (x0, f0, g0, b0, S0, S0.clone(), rho0, head0, i64(0), i64(1),
             i64(0), d0, dg0, zero + 1.0, i64(0), zero + math.inf,
             zero + 1.0, g0, b0)

    def read(flag):
        """The host's one read of a flag, OR-ed over the processes."""
        if processes is None:
            return bool(flag)
        from smoothsde_tpu_torch.parallel.collectives import sum_plain

        return bool(sum_plain(flag.to("cpu", torch.int64).reshape(1),
                              processes) > 0)

    capture = x0.is_cuda and b0.numel() == 0 and eager is None
    run = step
    if capture:
        from smoothsde_tpu_torch.infer.laplace import Graphed

        run = Graphed(step)
    more = read(go_on(i64(0), f0, g0, i64(0)))  # the start's one read
    steps = 0
    while more:
        *state, flag = run(*state)
        steps += 1
        more = read(flag)  # the one read of this step
    st = dict(zip(_FIELDS, state))
    graph = "eager" if eager is None else f"eager ({eager})"
    if capture:
        graph = next(iter(run.status.values()), "eager")
    return LBFGSResult(
        x=st["x"], f=st["f"], g=st["g"], b=st["b"], n_iter=st["k"],
        n_evals=st["evals"], converged=st["g"].abs().max() <= gtol(st["f"]),
        steps=steps, graph=graph)
