"""Compressed (colored) Hessians for the Laplace inner Newton.

Port of smoothsde_tpu/infer/coloring.py. The inner Newton needs H_bb,
the Hessian of the joint nllk in all smooth / random-effect
coefficients; dense jacfwd costs one forward-mode pass per coefficient.
An s(ID, bs='re') coefficient touches only its own track's rows, so
H_bb[i, j] can be nonzero only where two columns' row supports overlap
or a penalty couples them; columns with disjoint interaction sets share
one probe vector, and one forward pass recovers all their Hessian
columns (Curtis-Powell-Reid compression, TMB's sparse-Hessian coloring).

Reconstruction uses symmetry both ways: entry (i, j) is read from
HP[i, color(j)] when j is the only member of its color interacting with
i, else from HP[j, color(i)]. The planner (`_interaction_matrix`,
`_greedy_color`, `plan_coloring`: NumPy, the JAX package's verbatim)
checks on the host that every structurally nonzero entry is recoverable
and returns None (the dense fallback) otherwise: compression never
changes the result. `colored_hessian` is the torch.func counterpart of
the JAX `lax.map` of jvps.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch.func import jvp, vmap


def _interaction_matrix(supports: List[np.ndarray],
                        penalty_couplings: List[tuple], p: int) -> np.ndarray:
    """Boolean (p, p): columns i, j interact (possible H_bb[i,j] != 0):
    overlapping row supports, or a structurally-nonzero penalty entry
    couples them (an re smooth's identity penalty couples nothing;
    spline penalties are dense within their block)."""
    n_rows = max((int(s.max()) + 1 for s in supports if len(s)), default=0)
    inc = np.zeros((p, n_rows + 1), bool)
    for j, s in enumerate(supports):
        inc[j, s] = True
    inter = inc @ inc.T  # support overlap
    for cols, S_list in penalty_couplings:
        cols = np.asarray(cols, int)
        nz = np.zeros((len(cols), len(cols)), bool)
        for S in S_list:
            nz |= np.asarray(S) != 0.0
        inter[np.ix_(cols, cols)] |= nz
    np.fill_diagonal(inter, True)
    return inter


def _greedy_color(inter: np.ndarray) -> np.ndarray:
    """Greedy distance-1 coloring of the interaction graph (columns in
    one color are mutually non-interacting)."""
    p = inter.shape[0]
    colors = np.full(p, -1)
    order = np.argsort(-inter.sum(axis=1))  # most-connected first
    color_members: List[list] = []
    for j in order:
        for c, members in enumerate(color_members):
            if not inter[j, members].any():
                colors[j] = c
                members.append(j)
                break
        else:
            colors[j] = len(color_members)
            color_members.append([j])
    return colors


def plan_coloring(re_blocks, penalty_couplings) -> Optional[dict]:
    """Build the compressed-Hessian plan, or None when compression
    cannot help or exact reconstruction is not guaranteed.

    re_blocks: per-SDE-parameter dense design blocks (n, p_j) whose
      columns concatenate (in order) to the inner coefficient vector.
    penalty_couplings: list of (global column indices, [S matrices])
      per smooth block — coupling uses the STRUCTURAL nonzeros of the
      penalties (identity re penalties couple nothing).

    Returns {probe (p, C), row_idx (p, p), col_idx (p, p),
    mask (p, p), n_colors} with
      H[i, j] = HP[row_idx[i, j], col_idx[i, j]] where mask, 0 else.
    """
    cols = []
    for X in re_blocks:
        Xa = np.asarray(X)
        for j in range(Xa.shape[1]):
            cols.append(np.nonzero(Xa[:, j] != 0.0)[0])
    p = len(cols)
    if p == 0:
        return None
    inter = _interaction_matrix(cols, penalty_couplings, p)
    colors = _greedy_color(inter)
    C = int(colors.max()) + 1
    if C >= p:
        return None

    # validity: for entry (i, j), direction "via j's color" is clean
    # when j is the only member of color(j) interacting with i
    members = [np.nonzero(colors == c)[0] for c in range(C)]
    inter_count = np.zeros((p, C), int)  # row i x color c
    for c, mem in enumerate(members):
        inter_count[:, c] = inter[:, mem].sum(axis=1)

    row_idx = np.zeros((p, p), np.int32)
    col_idx = np.zeros((p, p), np.int32)
    ok = np.ones((p, p), bool)
    for i in range(p):
        for j in range(p):
            if not inter[i, j]:
                continue
            if inter_count[i, colors[j]] == 1:
                row_idx[i, j] = i
                col_idx[i, j] = colors[j]
            elif inter_count[j, colors[i]] == 1:
                row_idx[i, j] = j
                col_idx[i, j] = colors[i]
            else:
                ok[i, j] = False
    if not ok.all():
        return None  # dense fallback; never approximate

    probe = np.zeros((p, C))
    probe[np.arange(p), colors] = 1.0
    return {
        "probe": probe,
        "row_idx": row_idx,
        "col_idx": col_idx,
        "mask": inter,
        "n_colors": C,
        "p": p,
    }


def colored_hessian(grad_fn, plan):
    """hess(outer, b) -> dense (p, p) H_bb from `plan`: one
    torch.func.jvp of `grad_fn` (grad in b) per color, the colors
    batched by vmap as jacfwd batches its basis vectors. The plan's
    tensors are placed once per (dtype, device), at the first call with
    them (the Laplace layer calls it outside every torch.func
    transform)."""
    placed = {}

    def place(dtype, device):
        return (
            torch.as_tensor(plan["probe"].T, dtype=dtype, device=device),
            torch.as_tensor(plan["row_idx"], dtype=torch.int64,
                            device=device),
            torch.as_tensor(plan["col_idx"], dtype=torch.int64,
                            device=device),
            torch.as_tensor(plan["mask"], device=device),
        )

    def hess(outer, b):
        key = (b.dtype, b.device)
        if key not in placed:
            placed[key] = place(*key)
        probe_T, row_idx, col_idx, mask = placed[key]

        def one_color(v):
            return jvp(lambda bb: grad_fn(outer, bb), (b,), (v,))[1]

        HP = vmap(one_color)(probe_T).T  # (p, C)
        H = torch.where(mask, HP[row_idx, col_idx], 0.0)
        # exact symmetry (reconstruction picks directions per entry)
        return 0.5 * (H + H.T)

    return hess
