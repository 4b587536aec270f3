"""The plain likelihood of an isotropic linear-Gaussian state-space SDE.

Shared by the reference of each SDE type (`reference/<TYPE>.py`), which
gives the per-step system. It imports torch and nothing of the program.
The `ssm_*` functions at the end give the outer layout of an
intercept-only model with measurement error (BM_SSM, OU_SSM, CTCRW):
a type file takes them or writes its own.

The model, per track and per response dimension (the dimensions are
independent and share the parameters but the mean):
  - row 0 starts the track: the state x_1 of row 1 is N(a0, P0), with a0
    built from the observation of row 0, which adds no likelihood term;
  - x_{k+1} = T_k x_k + u_k + w_k, w_k ~ N(0, Q_k), for the interval
    dt_k = t_{k+1} - t_k;
  - y_k = x_k[0] + e_k, e_k ~ N(0, H), for k = 1 .. n - 1; H = 0 for
    a type observed without error.
The negative log-likelihood is the sum over tracks, dimensions and rows
1 .. n - 1 of (log S_k + v_k^2 / S_k) / 2, with v_k and S_k the one-step
prediction error and its variance, without the (log 2 pi) / 2 of each
term.

The filtered moments come from an associative scan of the filtering
elements (A, b, C, eta, J) of Sarkka and Garcia-Fernandez, "Temporal
parallelization of Bayesian smoothers", IEEE TAC 66(1), 2021, so that a
1M-step track takes log-depth torch calls; torch autograd gives the
gradient. Every product is a broadcast multiply and sum, never a matmul,
so a CUDA card computes it in the tensors' own precision (no TF32).
"""

from __future__ import annotations

import numpy as np
import torch


def mm(A, B):
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def mv(A, v):
    return (A * v[..., None, :]).sum(-1)


def tr(A):
    return A.transpose(-1, -2)


def inv(A):
    """Inverse of a batch of 1 x 1 or 2 x 2 matrices."""
    if A.shape[-1] == 1:
        return 1.0 / A
    a, b, c, d = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)],
                      -2)
    return adj / det[..., None, None]


def combine(e1, e2):
    """The element of e1 followed by e2 (e1 the earlier)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    M = inv(eye + mm(C1, J2))  # (I + C1 J2)^-1
    A2M = mm(A2, M)
    Nt = tr(M)  # (I + J2 C1)^-1, for symmetric C1 and J2
    A1tN = mm(tr(A1), Nt)
    return (mm(A2M, A1),
            mv(A2M, b1 + mv(C1, eta2)) + b2,
            mm(mm(A2M, C1), tr(A2)) + C2,
            mv(A1tN, eta2 - mv(J2, b1)) + eta1,
            mm(mm(A1tN, J2), A1) + J1)


def scan(fn, elems):
    """Inclusive associative scan of `fn` over the leading axis of every
    tensor in the tuple `elems` (the odd/even recursion)."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = scan(fn, fn(tuple(e[0:-1:2] for e in elems),
                      tuple(e[1::2] for e in elems)))
    rest = tuple(e[2::2] for e in elems)
    if n % 2 == 0:
        even = fn(tuple(o[:-1] for o in odd), rest)
    else:
        even = fn(odd, rest)
    even = tuple(torch.cat([e[:1], v]) for e, v in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):
        pairs = torch.stack([ev[:len(od)], od], 1).reshape(
            (2 * len(od),) + od.shape[1:])
        out.append(torch.cat([pairs, ev[len(od):]]))
    return tuple(out)


def nllk(system, obs, dt, H):
    """The negative log-likelihood (module docstring) of tracks of equal
    length.

    system: (T, u, Q, a0, P0) of the type, from `reference/<TYPE>.py`:
      T, Q (n, B, 1, s, s) and u (n, B, D, s) propagate row k to k + 1
      (rows 0 and n - 1 are not used), a0 (B, D, s) and P0 (s, s).
    obs: (n, B, D) observations; dt: (n, B) intervals; H: the
    observation error's variance, a scalar tensor (0 for none). Every
    tensor in the one dtype and on the one device.
    """
    T, u, Q, a0, P0 = system
    y = obs[1:]  # rows 1 .. n - 1
    # row 1: the prior (a0, P0) updated by y_1
    S0 = P0[0, 0] + H
    K0 = P0[:, 0] / S0
    m1 = a0 + K0 * (y[0] - a0[..., 0])[..., None]
    P1 = P0 - K0[:, None] * P0[0][None, :]
    # rows 2 .. n - 1: one step from the row before, then the update
    Tk, uk, Qk = T[1:-1], u[1:-1], Q[1:-1]
    S = Qk[..., 0, 0] + H  # (n - 2, B, 1)
    K = Qk[..., :, 0] / S[..., None]
    eye = torch.eye(P0.shape[-1], dtype=obs.dtype, device=obs.device)
    e0 = eye[0]
    IKZ = eye - K[..., :, None] * e0
    r = y[1:] - uk[..., 0]
    ZT = Tk[..., 0, :]
    elems = (mm(IKZ, Tk), uk + K * r[..., None], mm(IKZ, Qk),
             ZT * (r / S)[..., None],
             ZT[..., :, None] * ZT[..., None, :] / S[..., None, None])
    shape = (1,) + elems[0].shape[1:]
    first = (elems[0].new_zeros(shape), m1[None], P1.expand(shape),
             torch.zeros_like(m1[None]), elems[0].new_zeros(shape))
    elems = tuple(torch.cat([f, e.expand((e.shape[0],) + f.shape[1:])])
                  for f, e in zip(first, elems))
    _, m, P, _, _ = scan(combine, elems)  # filtered moments, rows 1 ..
    # one-step predictions of rows 2 .. n - 1
    m_pred = mv(Tk, m[:-1]) + uk
    P_pred = mm(mm(Tk, P[:-1]), tr(Tk)) + Qk
    S_pred = P_pred[..., 0, 0] + H
    v = y[1:] - m_pred[..., 0]
    total = (torch.log(S0) + (y[0] - a0[..., 0]) ** 2 / S0).sum()
    total = total + (torch.log(S_pred) + v * v / S_pred).sum()
    return 0.5 * total


# ---- the outer layout of an intercept-only model with measurement error --
#
# The fit's outer vector theta is (log sigma_obs, then one coefficient a
# parameter in the order of the configuration's formulas, on the link
# scale: identity for each mean mu1 .. muD, log for the rest), as the
# program's `FitResult.par` orders it.


def ssm_names(config):
    """The fit's outer parameter names (`FitResult.par_names`); refuses a
    configuration this layout does not describe."""
    if any(f.replace(" ", "") != "~1" for f in config["formulas"].values()):
        raise ValueError("this reference takes intercept-only formulas, "
                         f"not {config['formulas']}")
    return ["log_sigma_obs"] + ["coeff_fe"] * len(config["formulas"])


def ssm_truth(config):
    """The simulators' truth as an outer vector."""
    truth, D = config["truth"], len(config["response"])
    rest = list(config["formulas"])[D:]
    return np.concatenate([[np.log(truth["sigma_obs"])], truth["mu"],
                           np.log([truth[p] for p in rest])])


def ssm_start(config, obs):
    """The program's starting point for a job's observations obs (rows,
    D): log sigma_obs = log(0.3 x the median absolute step), then par0 on
    the link scale."""
    step = float(np.nanmedian(np.abs(np.diff(obs, axis=0))))
    par0 = np.asarray(config["par0"], float)
    D = len(config["response"])
    return np.concatenate([[np.log(0.3 * step)], par0[:D],
                           np.log(par0[D:])])


def ssm_nllk(system_fn, theta, obs, dt, dtype):
    """The nllk at the outer vector theta (a float64 tensor): the per-step
    system of `system_fn(coeff, obs, dt)` formed in float64 from theta's
    coefficients, then rounded to `dtype`, in which the filter runs."""
    system = tuple(a.to(dtype) for a in system_fn(theta[1:], obs, dt))
    H = torch.exp(2.0 * theta[0]).to(dtype)
    return nllk(system, obs.to(dtype), dt.to(dtype), H)
