"""Parameter packing: named parameter blocks <-> flat optimizer vectors,
with per-entry fixing (the TMB `map` mechanism, R/sde.R:621-632).

Port of smoothsde_tpu/infer/params.py. Blocks are named arrays
(coeff_fe, log_lambda, coeff_re, log_sigma_obs, ...); each entry is
either free (estimated) or fixed at its initial value. `unpack` builds
the named dict of tensors, differentiable in the free vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class ParamBlock:
    name: str
    init: np.ndarray  # (k,)
    fixed: np.ndarray  # (k,) bool; True = not estimated


class ParamPacker:
    """inner: the block whose free entries the Laplace approximation
    integrates out (TMB's `random=` vector). The ported slice has none
    free; fit_model refuses a packer with inner entries."""

    def __init__(self, blocks: List[ParamBlock], inner: str = "coeff_re"):
        self.blocks = {b.name: b for b in blocks}
        self.order = [b.name for b in blocks]
        self.inner = inner

        self._outer_index = []  # (block, idx) pairs in outer-vector order
        self._inner_index = []  # (block, idx) pairs in inner-vector order
        for name in self.order:
            b = self.blocks[name]
            target = (
                self._inner_index if name == inner else self._outer_index
            )
            for i in range(len(b.init)):
                if not b.fixed[i]:
                    target.append((name, i))
        self.n_outer = len(self._outer_index)
        self.n_inner = len(self._inner_index)

    def outer_names(self) -> List[str]:
        return [name for name, _ in self._outer_index]

    def inner_names(self) -> List[str]:
        return [name for name, _ in self._inner_index]

    def outer_init(self) -> np.ndarray:
        return np.array(
            [self.blocks[n].init[i] for n, i in self._outer_index], float
        )

    def unpack(self, outer: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full named parameter dict from the flat free outer vector (a
        tensor on the working device), fixed entries injected as
        constants; differentiable in `outer`."""
        full: Dict[str, torch.Tensor] = {}
        for name in self.order:
            base = torch.as_tensor(
                self.blocks[name].init, dtype=outer.dtype, device=outer.device
            )
            pairs = [(i, p) for p, (nm, i) in enumerate(self._outer_index)
                     if nm == name]
            if pairs:
                idx = torch.tensor([i for i, _ in pairs], device=outer.device)
                pos = torch.tensor([p for _, p in pairs], device=outer.device)
                base = base.index_put((idx,), outer[pos])
            full[name] = base
        return full

    def split_estimates(self, outer) -> Dict[str, np.ndarray]:
        """Full numpy dict of estimates (fixed entries at their values)."""
        outer = np.asarray(outer, float)
        full = {n: np.array(self.blocks[n].init, float) for n in self.order}
        for pos, (name, i) in enumerate(self._outer_index):
            full[name][i] = outer[pos]
        return full


def from_reference(full: Dict[str, np.ndarray], *, dtype=torch.float64,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """The port's parameter tensors from the JAX package's unpacked
    parameter dict (`packer.unpack(...)`, converted to NumPy).

    Both packages name and lay out the blocks identically (coeff_fe in
    formula column order, then log_lambda, coeff_re, and the model's
    extra blocks such as log_sigma_obs), so the map is block by block:
    each array becomes a 1-d tensor of `dtype` on `device`."""
    return {
        name: torch.as_tensor(
            np.array(v, np.float64).reshape(-1), dtype=dtype, device=device
        )
        for name, v in full.items()
    }
