"""Smoothing penalty: Gaussian priors on smooth coefficients.

Port of smoothsde_tpu/ops/penalty.py. Reference semantics
(nllk_sde.hpp:91-124 for closed-form models: a fully normalized Gaussian
log-prior N(0, (lambda S)^-1); the constant-free variant used by the
Kalman models, e.g. nllk_ctcrw.hpp:256-280):

  nllk += sum_i [ -Sn_i/2 * log(lambda_i) + lambda_i/2 * b_i' S_i b_i
                  (+ Sn_i/2 log(2 pi) - 1/2 log det S_i  if normalize) ]

Multi-penalty groups (tensor-product smooths te/ti, beyond the
reference, whose TMB penalty assumes one lambda per block): a block's
prior precision is P(lambda) = sum_j lambda_j S_j over shared
coefficients, contributing

  nllk += 1/2 b' P b - 1/2 log det P (+ p/2 log 2pi if normalize)

with log det P evaluated in-graph (small dense blocks). Use shrinkage
margins (bs='cs') so P is SPD.

Single-matrix log-determinants are data constants computed on the host.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

_LOG_2PI = math.log(2.0 * math.pi)


def make_penalty(S_groups: List[List[np.ndarray]], normalize: bool, *,
                 dtype=torch.float64, device="cpu"):
    """Build penalty_fn(coeff_re, log_lambda) -> 0-d tensor nllk term.

    S_groups: one entry per coefficient block; each entry is the list of
    penalty matrices over that block's coefficients. log_lambda is
    indexed over the flattened matrix order. The matrices live on
    `device` in `dtype`.
    """
    # a flat list of matrices = singleton groups
    if S_groups and isinstance(S_groups[0], np.ndarray):
        S_groups = [[S] for S in S_groups]
    sizes = [g[0].shape[0] for g in S_groups]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    groups_dev = [
        [torch.as_tensor(np.asarray(S, np.float64)).to(device=device,
                                                       dtype=dtype)
         for S in g]
        for g in S_groups
    ]
    logdets = [
        float(np.linalg.slogdet(g[0])[1]) if (normalize and len(g) == 1)
        else 0.0
        for g in S_groups
    ]

    def penalty(coeff_re, log_lambda):
        # The terms are shape-(1,) tensors, not 0-d ones: under
        # torch.func's jvp a Python float times a 0-d tensor loses its
        # wrapped-number status and promotes an f32 term to f64.
        total = coeff_re.new_zeros(1)
        li = 0
        for i, g in enumerate(groups_dev):
            b = coeff_re[offsets[i] : offsets[i + 1]]
            if len(g) == 1:
                lam = log_lambda[li : li + 1]
                quad = (b @ (g[0] @ b)).reshape(1)
                term = -0.5 * sizes[i] * lam + 0.5 * torch.exp(lam) * quad
                if normalize:
                    term = (
                        term + 0.5 * sizes[i] * _LOG_2PI - 0.5 * logdets[i]
                    )
                li += 1
            else:
                lams = torch.exp(log_lambda[li : li + len(g)])
                P = sum(lam * S for lam, S in zip(lams, g))
                quad = (b @ (P @ b)).reshape(1)
                _, logdetP = torch.linalg.slogdet(P)
                term = 0.5 * (quad - logdetP.reshape(1))
                if normalize:
                    term = term + 0.5 * sizes[i] * _LOG_2PI
                li += len(g)
            total = total + term
        return total[0]

    return penalty
