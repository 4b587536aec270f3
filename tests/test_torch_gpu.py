"""CUDA kernels of smoothsde_tpu_torch against their plain PyTorch
versions on the card. Every test is marked `gpu` and skips without a
CUDA device. This file imports neither jax nor the JAX package, so it
also runs where jax is not installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import numpy as np
import pytest
import torch

from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.ops.kalman_soa import (
    CtcrwFusedCore,
    CtcrwPlainCore,
    prepare_ctcrw_data,
)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(d, n, seed):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.05, 0.5, size=n))
    ids = (np.arange(n) >= n // 3).astype(int)
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[rng.integers(1, n, size=max(2, n // 40))] = np.nan
    par = np.column_stack([
        0.1 * rng.normal(size=(n, d)),
        np.log(2.0) + 0.3 * rng.normal(size=n),
        np.log(0.8) + 0.3 * rng.normal(size=n),
    ])
    return obs, times, ids, par


def _value_grad(core, obs, times, ids, par, dtype, device):
    data = prepare_ctcrw_data(obs, times, ids, dtype=dtype, device=device)
    p = torch.tensor(par, dtype=dtype, device=device, requires_grad=True)
    h = torch.tensor(0.04, dtype=dtype, device=device, requires_grad=True)
    v = core.apply(p, data.yd, h, data.dtv, data.resetf, data.validf,
                   1.0, 10.0)
    v.backward()
    return (v.item(), p.grad.double().cpu().numpy(), h.grad.item())


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(1, 80), (2, 5000), (3, 20000)])
def test_kernels_match_plain_f64(cuda, d, n):
    """Through the autograd.Function: value rtol 1e-10, gradient 1e-8 of
    the largest component; every kernel launched once per direction."""
    obs, times, ids, par = _data(d, n, 10 * d)
    cf.reset_launches()
    v, g, gh = _value_grad(CtcrwFusedCore, obs, times, ids, par,
                           torch.float64, cuda)
    assert all(c == 1 for c in cf.LAUNCHES.values()), cf.LAUNCHES
    rv, rg, rgh = _value_grad(CtcrwPlainCore, obs, times, ids, par,
                              torch.float64, cuda)
    assert all(c == 1 for c in cf.LAUNCHES.values()), "plain path launched"
    assert v == pytest.approx(rv, rel=1e-10)
    np.testing.assert_allclose(g, rg, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(rg)))
    assert gh == pytest.approx(rgh, rel=1e-8)


@pytest.mark.gpu
def test_f32_kernels_within_accuracy_bar(cuda):
    """f32 kernels vs the f64 plain version, the docs/ACCURACY.md bar:
    value within 1e-4 relative; the gradient of the per-column
    parameters (the per-step gradients summed over steps, what a fit
    with intercept formulas sees) within 1e-4 of its largest component.
    """
    obs, times, ids, par = _data(2, 50000, 7)
    v, g, _ = _value_grad(CtcrwFusedCore, obs, times, ids, par,
                          torch.float32, cuda)
    rv, rg, _ = _value_grad(CtcrwPlainCore, obs, times, ids, par,
                            torch.float64, cuda)
    g, rg = g.sum(0), rg.sum(0)
    assert v == pytest.approx(rv, rel=1e-4)
    assert np.max(np.abs(g - rg)) <= 1e-4 * np.max(np.abs(rg))


@pytest.mark.gpu
def test_wrapper_refuses_cpu_pointer(cuda):
    """The launcher passes only CUDA tensors to a kernel."""
    from smoothsde_tpu_torch.ops import _kernels

    tot = torch.zeros((14, 8), device=cuda)
    with pytest.raises(TypeError):
        _kernels.launch("block_prefix_filter", tot, tot.cpu(), 2, 4, 0)
