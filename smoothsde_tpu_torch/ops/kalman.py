"""Linear-Gaussian Kalman filtering: the sequential filter, the
log-depth parallel (associative-scan) filter, and batching by track.

Port of smoothsde_tpu/ops/kalman.py. It is plain tensor arithmetic:
every order of torch.func (vmap, jvp, grad) runs through it, which is
what the Laplace layer's forward-mode twin of the state-space likelihood
needs (infer/objective.py `loglik_ad`). It reaches no CUDA kernel.

Filter semantics (identical to the reference loops, nllk_ctcrw.hpp:
195-247):
  - the carry is the PREDICTED state (a, P) for the current observation;
  - at a track start (`reset`) the carry is re-initialized to (a0, P0)
    and the observation contributes no likelihood;
  - at a missing observation (`valid == False`) predict only:
    a <- T a + b, P <- T P T' + Q;
  - otherwise u = y - Z a, F = Z P Z' + H,
    llk += -(log det F + u' F^-1 u)/2, K = P Z' F^-1, with a
    predict-only fallback when det F <= 0 (nllk_ctcrw.hpp:226-229);
  - (T_i, b_i, Q_i) propagate from observation i to i + 1.

The parallel form composes the associative filtering elements (A, b, C,
eta, J) of Sarkka & Garcia-Fernandez, extended with per-step drift,
missing observations and in-scan track resets (a reset element absorbs
what precedes it), by the odd/even recursion of
jax.lax.associative_scan: ~2n combines at depth 2 log2(n), then the
likelihood terms in one elementwise pass over the filtered moments
(`predictive_loglik_terms`). "parallel" is the card's filter and
"sequential" the CPU's (`default_filter_impl`, the JAX package's TPU /
CPU split). Every function takes leading batch axes before the step
axis.

The small products are broadcast multiplies and sums, never a matmul:
the JAX package pins its filter's dots to full f32 precision
(`_full_precision`: bf16 truncation cost 27% of the gradient there), and
on a CUDA card a matmul may run in TF32. The inverses and determinants
are closed forms for sizes 1 and 2 (`_solve_small`, `_slogdet_small`),
as in the JAX package; above, `torch.linalg.solve_ex` without its error
check (no host sync; a singular system gives non-finite values, as
jnp.linalg.solve does).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class KalmanSteps(NamedTuple):
    """Stacked per-step system matrices for a sequence of length n,
    with any leading batch axes (per-dim factorization, tracks).

    Shapes (s = state dim, m = observation dim), after the batch axes:
      T (n, s, s) transition, propagates obs i -> i+1; b (n, s) drift;
      Q (n, s, s) process noise; Z (n, m, s) observation matrix;
      H (n, m, m) observation noise; y (n, m) observations (sanitized);
      a0 (n, s), P0 (n, s, s) the initial state, used where reset;
      reset (n,) bool track starts (the first must be True);
      valid (n,) bool observation present.
    """

    T: torch.Tensor
    b: torch.Tensor
    Q: torch.Tensor
    Z: torch.Tensor
    H: torch.Tensor
    y: torch.Tensor
    a0: torch.Tensor
    P0: torch.Tensor
    reset: torch.Tensor
    valid: torch.Tensor


def _mm(A, B):
    """A @ B over the last two axes as a broadcast multiply and sum (no
    matmul: exact f32 or f64 products on every device)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _mv(A, v):
    return (A * v[..., None, :]).sum(-1)


def _t(A):
    return A.transpose(-1, -2)


def _sym(M):
    return 0.5 * (M + _t(M))


def _solve_small(A, B):
    """Batched solve A X = B; closed-form inverses for sizes 1 and 2,
    torch.linalg.solve above."""
    s = A.shape[-1]
    if s == 1:
        return B / A[..., :1, :]
    if s == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], dim=-1),
                           torch.stack([-c, a], dim=-1)], dim=-2)
        return _mm(inv / det[..., None, None], B)
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _slogdet_small(F):
    """Batched (sign, log|det|); closed forms for sizes 1 and 2."""
    m = F.shape[-1]
    if m == 1:
        d = F[..., 0, 0]
    elif m == 2:
        d = F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
    else:
        return torch.linalg.slogdet(F)
    return torch.sign(d), torch.log(torch.abs(d))


def _sequential_scan(steps: KalmanSteps):
    """The sequential filter, a Python loop over the step axis (the axis
    after any batch axes): yields per step (u, F, ok, llk term, a_next),
    the prediction error and covariance, whether a measurement update
    happened, its log-density term and the state carried to the next
    step."""
    nb = steps.reset.dim() - 1  # batch axes before the step axis
    s = steps.T.shape[-1]
    dtype, device = steps.T.dtype, steps.T.device
    eye_s = torch.eye(s, dtype=dtype, device=device)
    eye_m = torch.eye(steps.H.shape[-1], dtype=dtype, device=device)
    xs = [x.movedim(nb, 0).unbind(0) for x in steps]
    a, P = xs[6][0], xs[7][0]
    for i in range(len(xs[0])):
        T, b, Q, Z, H, y, a0, P0, reset, valid = (x[i] for x in xs)
        r1, r2 = reset[..., None], reset[..., None, None]
        a_pred = torch.where(r1, a0, a)
        P_pred = torch.where(r2, P0, P)
        u = y - _mv(Z, a_pred)
        PZt = _mm(P_pred, _t(Z))
        F = _mm(Z, PZt) + H
        sign, logdet = _slogdet_small(F)
        ok = valid & ~reset & (sign > 0) & torch.isfinite(logdet)
        F_safe = torch.where(ok[..., None, None], F, eye_m)
        Finv_u = _solve_small(F_safe, u[..., None])[..., 0]
        llk = torch.where(ok, -0.5 * (logdet + (u * Finv_u).sum(-1)), 0.0)
        K = _t(_solve_small(F_safe, _t(PZt)))  # P Z' F^-1
        a_filt = torch.where(ok[..., None], a_pred + _mv(K, u), a_pred)
        P_filt = torch.where(ok[..., None, None],
                             _mm(eye_s - _mm(K, Z), P_pred), P_pred)
        # a reset state is carried un-propagated: the prediction for the
        # observation after a track start is exactly (a0, P0)
        a = torch.where(r1, a_pred, _mv(T, a_filt) + b)
        P = torch.where(r2, P_pred, _sym(_mm(_mm(T, P_filt), _t(T)) + Q))
        yield u, F, ok, llk, torch.where(r1, a0, a)


def kalman_loglik_sequential(steps: KalmanSteps, with_states: bool = False):
    """Sequential filter (`_sequential_scan`). Returns the llk summed over
    steps, of the shape of the batch axes; with_states=True returns
    (llk, aest_all), aest_all (..., n, s) the reference's
    REPORT(aest_all) (nllk_ctcrw.hpp:249): row i the state estimate after
    observation i (the prediction for i + 1, or a0 at a reset)."""
    out = list(_sequential_scan(steps))
    llk = torch.stack([o[3] for o in out], dim=-1).sum(-1)
    if with_states:
        return llk, torch.stack([o[4] for o in out],
                                dim=steps.reset.dim() - 1)
    return llk


# ---------------------------------------------------------------------------
# Parallel (associative scan) filter
# ---------------------------------------------------------------------------


class _Element(NamedTuple):
    """Associative filtering element (A, b, C, eta, J): leaves
    (..., n, s, s) and (..., n, s)."""

    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _combine(e1: _Element, e2: _Element) -> _Element:
    """Composition e2 after e1 (both batched on leading axes)."""
    eye = torch.eye(e1.A.shape[-1], dtype=e1.A.dtype, device=e1.A.device)
    # M = (I + C1 J2)^-1; N = (I + J2 C1)^-1 = M' for symmetric C, J
    C1J2 = _mm(e1.C, e2.J)
    M = _solve_small(eye + C1J2, eye.expand(C1J2.shape))
    A2M = _mm(e2.A, M)
    A = _mm(A2M, e1.A)
    b = _mv(A2M, e1.b + _mv(e1.C, e2.eta)) + e2.b
    C = _sym(_mm(_mm(A2M, e1.C), _t(e2.A)) + e2.C)
    A1tN = _mm(_t(e1.A), _t(M))
    eta = _mv(A1tN, e2.eta - _mv(e2.J, e1.b)) + e1.eta
    J = _sym(_mm(_mm(A1tN, e2.J), e1.A) + e1.J)
    return _Element(A, b, C, eta, J)


def _prev(x, first, ax):
    """x shifted one step along axis ax: `first` (one step) at 0."""
    return torch.cat([first, x.narrow(ax, 0, x.shape[ax] - 1)], dim=ax)


def _shifted_transitions(steps: KalmanSteps):
    """(Ft, ct, Qt): the transition entering each step (from row i - 1;
    the identity out of a reset, matching the reference's un-propagated
    track starts)."""
    ax = steps.reset.dim() - 1
    s = steps.T.shape[-1]
    prev_reset = _prev(steps.reset, torch.ones_like(steps.reset.narrow(
        ax, 0, 1)), ax)
    eye = torch.eye(s, dtype=steps.T.dtype, device=steps.T.device)
    Ft = torch.where(prev_reset[..., None, None], eye,
                     _prev(steps.T, eye.expand_as(steps.T.narrow(ax, 0, 1)),
                           ax))
    ct = torch.where(prev_reset[..., None], 0.0,
                     _prev(steps.b, torch.zeros_like(steps.b.narrow(ax, 0, 1)),
                           ax))
    Qt = torch.where(prev_reset[..., None, None], 0.0,
                     _prev(steps.Q, torch.zeros_like(steps.Q.narrow(ax, 0, 1)),
                           ax))
    return Ft, ct, Qt


def _build_elements(steps: KalmanSteps) -> _Element:
    """Per-step filtering elements: the propagation from i - 1 to i (the
    identity when i - 1 or i is a reset) composed with the measurement
    update at i (skipped when invalid or a reset)."""
    Ft, ct, Qt = _shifted_transitions(steps)
    Z, H, y = steps.Z, steps.H, steps.y
    eye_s = torch.eye(Z.shape[-1], dtype=Z.dtype, device=Z.device)
    eye_m = torch.eye(Z.shape[-2], dtype=Z.dtype, device=Z.device)
    update = steps.valid & ~steps.reset
    u2, u1 = update[..., None, None], update[..., None]

    # S = Z Q Z' + H must be PD where an update happens; sanitized elsewhere
    S = torch.where(u2, _mm(_mm(Z, Qt), _t(Z)) + H, eye_m)
    ZtSinv = _t(_solve_small(S, Z))  # Z' S^-1
    K = _mm(Qt, ZtSinv)  # (..., n, s, m)
    resid = y - _mv(Z, ct)
    IKZ = eye_s - _mm(K, Z)
    FtZtSinv = _mm(_t(Ft), ZtSinv)

    # three cases per step: reset / propagate+update / propagate-only
    r2, r1 = steps.reset[..., None, None], steps.reset[..., None]
    A = torch.where(r2, 0.0, torch.where(u2, _mm(IKZ, Ft), Ft))
    b = torch.where(r1, steps.a0, torch.where(u1, ct + _mv(K, resid), ct))
    C = torch.where(r2, steps.P0, torch.where(u2, _sym(_mm(IKZ, Qt)), Qt))
    eta = torch.where(u1, _mv(FtZtSinv, resid), 0.0)
    J = torch.where(u2, _sym(_mm(_mm(FtZtSinv, Z), Ft)), 0.0)
    return _Element(A, b, C, eta, J)


def _interleave(a, b, ax):
    """a at the even and b at the odd positions along axis ax
    (len(a) = len(b) or len(b) + 1)."""
    k = b.shape[ax]
    out = torch.stack([a.narrow(ax, 0, k), b], dim=ax + 1).flatten(ax, ax + 1)
    if a.shape[ax] == k:
        return out
    return torch.cat([out, a.narrow(ax, k, 1)], dim=ax)


def _associative_scan(combine, elems, ax):
    """Inclusive scan of the element tuple `elems` along axis ax by the
    odd/even recursion of jax.lax.associative_scan: combine the pairs,
    scan the pair totals, then fold each even position onto the total
    before it."""
    n = elems[0].shape[ax]
    if n < 2:
        return elems
    cls = type(elems)

    def sl(x, start, stop=None, step=1):
        return x[(slice(None),) * ax + (slice(start, stop, step),)]

    odd = _associative_scan(
        combine, combine(cls(*(sl(x, 0, -1, 2) for x in elems)),
                         cls(*(sl(x, 1, None, 2) for x in elems))), ax)
    tail = cls(*(sl(x, 2, None, 2) for x in elems))
    if n % 2 == 0:
        even = combine(cls(*(sl(x, 0, -1) for x in odd)), tail)
    else:
        even = combine(odd, tail)
    return cls(*(_interleave(torch.cat([sl(e, 0, 1), r], dim=ax), o, ax)
                 for e, r, o in zip(elems, even, odd)))


def _predictive(steps: KalmanSteps, m_f, P_f):
    """The one-step-ahead prediction errors u = y - Z a_pred and
    covariances F = Z P_pred Z' + H from the filtered moments (m_f
    (..., n, s), P_f (..., n, s, s)), and the update mask."""
    ax = steps.reset.dim() - 1
    Ft, ct, Qt = _shifted_transitions(steps)
    m_prev = _prev(m_f, steps.a0.narrow(ax, 0, 1), ax)
    P_prev = _prev(P_f, steps.P0.narrow(ax, 0, 1), ax)
    r1, r2 = steps.reset[..., None], steps.reset[..., None, None]
    a_pred = torch.where(r1, steps.a0, _mv(Ft, m_prev) + ct)
    P_pred = torch.where(r2, steps.P0, _mm(_mm(Ft, P_prev), _t(Ft)) + Qt)
    u = steps.y - _mv(steps.Z, a_pred)
    F = _mm(_mm(steps.Z, P_pred), _t(steps.Z)) + steps.H
    return u, F, steps.valid & ~steps.reset


def predictive_loglik_terms(steps: KalmanSteps, m_f, P_f):
    """Per-step predictive log-density terms (..., n) from the filtered
    moments: one elementwise pass."""
    u, F, update = _predictive(steps, m_f, P_f)
    eye_m = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    F_safe = torch.where(update[..., None, None], F, eye_m)
    _, logdet = _slogdet_small(F_safe)
    Finv_u = _solve_small(F_safe, u[..., None])[..., 0]
    return torch.where(update, -0.5 * (logdet + (u * Finv_u).sum(-1)), 0.0)


def kalman_filter_parallel(steps: KalmanSteps):
    """Log-depth parallel Kalman filter. Returns (llk of the batch shape,
    filtered means (..., n, s), filtered covariances (..., n, s, s)):
    E[x_i | y_<=i] within each track, the sequential filter's
    measurement-updated states."""
    ax = steps.reset.dim() - 1
    scanned = _associative_scan(_combine, _build_elements(steps), ax)
    m_f, P_f = scanned.b, scanned.C
    return predictive_loglik_terms(steps, m_f, P_f).sum(-1), m_f, P_f


def default_filter_impl(device) -> str:
    """The filter for a device: "parallel" on a CUDA device, "sequential"
    on the CPU (the JAX package's TPU / CPU split)."""
    return "parallel" if torch.device(device).type == "cuda" else \
        "sequential"


def kalman_loglik(steps: KalmanSteps, impl: str = "auto"):
    """Filter log-likelihood (of the batch shape) through `impl`:
    "sequential", "parallel" or "auto" (`default_filter_impl` of the
    steps' device)."""
    if impl == "auto":
        impl = default_filter_impl(steps.T.device)
    if impl == "sequential":
        return kalman_loglik_sequential(steps)
    if impl == "parallel":
        return kalman_filter_parallel(steps)[0]
    raise ValueError(f"unknown Kalman impl {impl!r}")


def kalman_loglik_batched(steps: KalmanSteps, impl: str = "auto"):
    """Total log-likelihood over a batch of independent sequences (one
    leading axis on every leaf: the per-dim factorization, or tracks)."""
    return kalman_loglik(steps, impl).sum()


def track_pad_plan(ids, max_waste: float = 2.0, *, device="cpu"):
    """Host-side plan to split concatenated multi-track steps into a
    padded (track, step) batch, so that the sequential filter's depth is
    the longest track instead of n (tracks are independent: the
    reference skips cross-ID transitions, nllk_ctcrw.hpp:196-200).

    Returns (perm, pad) on `device`, or None when there is one track or
    when padding would inflate the steps by more than `max_waste`: perm
    (n_tracks, L_max) int64 positions of each track's steps in the
    concatenated order, padded by repeating its last position, and pad
    the matching bool mask (True at padding). NumPy, made once at build
    time, outside every transform."""
    ids = np.asarray(ids)
    n = ids.shape[0]
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    if len(starts) <= 1:
        return None
    bounds = np.r_[starts, n]
    lengths = np.diff(bounds)
    L = int(lengths.max())
    if len(starts) * L > max_waste * n:
        return None
    perm = np.empty((len(starts), L), np.int64)
    pad = np.zeros((len(starts), L), bool)
    for k, (s, ln) in enumerate(zip(bounds[:-1], lengths)):
        perm[k, :ln] = np.arange(s, s + ln)
        perm[k, ln:] = s + ln - 1
        pad[k, ln:] = True
    return (torch.as_tensor(perm, device=device),
            torch.as_tensor(pad, device=device))


def batch_steps_by_track(steps: KalmanSteps, perm, pad) -> KalmanSteps:
    """Batched steps (leaves (B, n, ...)) as per-track padded batches
    (leaves (B * n_tracks, L_max, ...)) per a `track_pad_plan`. Padding
    rows repeat the track's last step with valid and reset cleared: the
    carry propagates through them with that step's finite transition and
    they add no likelihood, so the total equals the concatenated
    filter's."""
    K, L = perm.shape

    def g(x):
        out = x[:, perm]  # (B, K, L, ...)
        return out.reshape((x.shape[0] * K, L) + tuple(x.shape[2:]))

    out = KalmanSteps(*(g(x) for x in steps))
    keep = (~pad).repeat(steps.valid.shape[0], 1)  # (B * K, L)
    return out._replace(valid=out.valid & keep, reset=out.reset & keep)


def kalman_innovations(steps: KalmanSteps, impl: str = "sequential"):
    """One-step-ahead innovations for residual diagnostics: (u (..., n,
    m), F (..., n, m, m), ok (..., n)), the prediction errors
    y - Z a_pred and covariances Z P Z' + H at every step where a
    measurement update happens (ok), u zero and F the identity
    elsewhere. Whitened residuals chol(F)^-1 u are iid N(0, I) under the
    model. impl "sequential" is the JAX package's scan; "parallel" reads
    the same quantities off the parallel filter's filtered moments (the
    card's route: no loop over the steps)."""
    if impl == "parallel":
        _, m_f, P_f = kalman_filter_parallel(steps)
        u, F, ok = _predictive(steps, m_f, P_f)
        sign, logdet = _slogdet_small(F)
        ok = ok & (sign > 0) & torch.isfinite(logdet)
    elif impl == "sequential":
        out = list(_sequential_scan(steps))
        nb = steps.reset.dim() - 1
        u, F, ok = (torch.stack([o[k] for o in out], dim=nb)
                    for k in range(3))
    else:
        raise ValueError(f"unknown Kalman impl {impl!r}")
    eye_m = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    return (torch.where(ok[..., None], u, 0.0),
            torch.where(ok[..., None, None], F, eye_m), ok)


def filtered_to_reported_states(steps: KalmanSteps, m_f):
    """Filtered means (..., n, s) in the reference's aest_all convention
    (propagated one step forward; a0 at resets), nllk_ctcrw.hpp:230-246."""
    return torch.where(steps.reset[..., None], steps.a0,
                       _mv(steps.T, m_f) + steps.b)
