"""Linear-Gaussian Kalman filtering: the sequential filter and its
batching by track.

Port of the sequential half of smoothsde_tpu/ops/kalman.py
(`KalmanSteps`, `_sym`, `_solve_small`, `_slogdet_small`,
`kalman_loglik_sequential`, `kalman_loglik_batched`, `track_pad_plan`,
`batch_steps_by_track`). It is plain tensor arithmetic: every order of
torch.func (vmap, jvp, grad) runs through it, which is what the Laplace
layer's forward-mode twin of the state-space likelihood needs
(infer/objective.py `loglik_ad`). It reaches no CUDA kernel.

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

The small products are broadcast multiplies and sums, never a matmul:
the JAX package pins its filter's dots to full f32 precision
(`_full_precision`: bf16 truncation cost 27% of the gradient there), and
on a CUDA card a matmul may run in TF32. The inverses and determinants
are closed forms for sizes 1 and 2 (`_solve_small`, `_slogdet_small`),
as in the JAX package. The generic associative filter, the
innovations and the reported states are not ported yet (ROADMAP queue 1
item 5).
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
    return torch.linalg.solve(A, B)


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


def kalman_loglik_sequential(steps: KalmanSteps):
    """Sequential filter, a Python loop over the step axis (the axis
    after any batch axes). Returns the llk summed over steps, of the
    shape of the batch axes. (The JAX package's `with_states`, the
    reported states, waits for ROADMAP queue 1 item 5.)"""
    nb = steps.reset.dim() - 1  # batch axes before the step axis
    s = steps.T.shape[-1]
    dtype, device = steps.T.dtype, steps.T.device
    eye_s = torch.eye(s, dtype=dtype, device=device)
    eye_m = torch.eye(steps.H.shape[-1], dtype=dtype, device=device)
    xs = [x.movedim(nb, 0).unbind(0) for x in steps]
    a, P = xs[6][0], xs[7][0]
    llks = []
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
        llks.append(torch.where(ok, -0.5 * (logdet + (u * Finv_u).sum(-1)),
                                0.0))
        K = _t(_solve_small(F_safe, _t(PZt)))  # P Z' F^-1
        a_filt = torch.where(ok[..., None], a_pred + _mv(K, u), a_pred)
        P_filt = torch.where(ok[..., None, None],
                             _mm(eye_s - _mm(K, Z), P_pred), P_pred)
        # a reset state is carried un-propagated: the prediction for the
        # observation after a track start is exactly (a0, P0)
        a_prop = _mv(T, a_filt) + b
        P_prop = _sym(_mm(_mm(T, P_filt), _t(T)) + Q)
        a = torch.where(r1, a_pred, a_prop)
        P = torch.where(r2, P_pred, P_prop)
    return torch.stack(llks, dim=-1).sum(-1)


def kalman_loglik_batched(steps: KalmanSteps):
    """Total log-likelihood over a batch of independent sequences (one
    leading axis on every leaf: the per-dim factorization, or tracks),
    through the sequential filter (the JAX package's
    impl="sequential"; its associative filter waits for ROADMAP queue 1
    item 5)."""
    return kalman_loglik_sequential(steps).sum()


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
