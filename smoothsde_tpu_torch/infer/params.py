"""Parameter packing: named parameter blocks <-> flat optimizer vectors,
with per-entry fixing (the TMB `map` mechanism, R/sde.R:621-632).

Port of smoothsde_tpu/infer/params.py. Blocks are named arrays
(coeff_fe, log_lambda, log_decay, coeff_re, log_sigma_obs, ...); each
entry is either free (estimated) or fixed at its initial value. The free
entries of the "inner" blocks are integrated out by the Laplace
approximation; the remaining free entries form the outer vector.
`unpack` builds the named dict of tensors, differentiable in both free
vectors and usable inside torch.func transforms (each block is one
gather from the free vectors and the fixed constants).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ParamBlock:
    name: str
    init: np.ndarray  # (k,)
    fixed: np.ndarray  # (k,) bool; True = not estimated


class ParamPacker:
    """inner: one block name, or a tuple of names. Every free entry of an
    inner block is integrated out by the Laplace approximation (TMB's
    `random=` vector; `random=c("coeff_fe", "coeff_re")` is the
    TMB-documented REML construction)."""

    def __init__(self, blocks: List[ParamBlock], inner="coeff_re"):
        self.blocks = {b.name: b for b in blocks}
        self.order = [b.name for b in blocks]
        inner_names = (inner,) if isinstance(inner, str) else tuple(inner)
        self.inner = inner_names[0] if len(inner_names) == 1 else inner_names
        inner_set = set(inner_names)

        self._outer_index = []  # (block, idx) pairs in outer-vector order
        self._inner_index = []  # (block, idx) pairs in inner-vector order
        for name in self.order:
            b = self.blocks[name]
            target = (
                self._inner_index if name in inner_set else self._outer_index
            )
            for i in range(len(b.init)):
                if not b.fixed[i]:
                    target.append((name, i))
        self.n_outer = len(self._outer_index)
        self.n_inner = len(self._inner_index)

        # gather plan: each block entry indexes cat(outer, inner, consts)
        consts = np.concatenate(
            [np.asarray(self.blocks[n].init, float) for n in self.order]
            or [np.zeros(0)])
        self._consts = consts
        pos = {}
        for p, key in enumerate(self._outer_index):
            pos[key] = p
        for p, key in enumerate(self._inner_index):
            pos[key] = self.n_outer + p
        self._gather = {}
        off = self.n_outer + self.n_inner
        for name in self.order:
            k = len(self.blocks[name].init)
            self._gather[name] = np.array(
                [pos.get((name, i), off + i) for i in range(k)], np.int64)
            off += k
        self._on_device = {}

    # -- names --------------------------------------------------------------

    def outer_names(self) -> List[str]:
        return [name for name, _ in self._outer_index]

    def inner_names(self) -> List[str]:
        return [name for name, _ in self._inner_index]

    # -- packing ------------------------------------------------------------

    def outer_init(self) -> np.ndarray:
        return np.array(
            [self.blocks[n].init[i] for n, i in self._outer_index], float
        )

    def inner_init(self) -> np.ndarray:
        return np.array(
            [self.blocks[n].init[i] for n, i in self._inner_index], float
        )

    def unpack(self, outer: torch.Tensor,
               inner: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """Full named parameter dict from the flat free vectors (tensors
        on the working device), fixed entries injected as constants;
        differentiable in `outer` and `inner`. Without `inner`, the inner
        entries take their initial values."""
        placed = self._on_device.get((outer.dtype, outer.device))
        inner0, consts, gather = placed or self._constants(outer.dtype,
                                                           outer.device)
        src = torch.cat([outer, inner0 if inner is None else inner, consts])
        return {name: src[gather[name]] for name in self.order}

    def _constants(self, dtype, device):
        return (
            torch.as_tensor(self.inner_init(), dtype=dtype, device=device),
            torch.as_tensor(self._consts, dtype=dtype, device=device),
            {name: torch.as_tensor(g, device=device)
             for name, g in self._gather.items()},
        )

    def place(self, dtype, device):
        """Keep the fixed values and gather indices on `device` in
        `dtype`, so that `unpack` moves nothing per call. Call it outside
        any torch.func transform: a tensor made inside one belongs to it."""
        device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
        self._on_device[(dtype, device)] = self._constants(dtype, device)

    def split_estimates(self, outer, inner=None) -> Dict[str, np.ndarray]:
        """Full numpy dict of estimates (fixed entries at their values)."""
        outer = np.asarray(outer, float)
        full = {n: np.array(self.blocks[n].init, float) for n in self.order}
        for pos, (name, i) in enumerate(self._outer_index):
            full[name][i] = outer[pos]
        if inner is not None:
            inner = np.asarray(inner, float)
            for pos, (name, i) in enumerate(self._inner_index):
                full[name][i] = inner[pos]
        return full


def from_reference(full: Dict[str, np.ndarray], *, dtype=torch.float64,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """The port's parameter tensors from the JAX package's unpacked
    parameter dict (`packer.unpack(outer, inner)`, converted to NumPy).

    Both packages name and lay out the blocks identically (coeff_fe in
    formula column order, then log_lambda, log_decay, coeff_re, and the
    model's extra blocks such as log_sigma_obs), so the map is block by
    block: each array, the random-effect, smoothing and decay blocks
    included, becomes a 1-d tensor of `dtype` on `device`."""
    return {
        name: torch.as_tensor(
            np.array(v, np.float64).reshape(-1), dtype=dtype, device=device
        )
        for name, v in full.items()
    }
