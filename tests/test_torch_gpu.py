"""CUDA kernels of smoothsde_tpu_torch against their plain PyTorch
versions on the card: the CTCRW kernels and the scalar-state (BM_SSM /
OU_SSM) ones, and the launcher's argument checks. Every test that needs
the card is marked `gpu` and skips without a CUDA device. This file
imports neither jax nor the JAX package, so it also runs where jax is
not installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import numpy as np
import pytest
import torch

from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.ops import diag_fused as df
from smoothsde_tpu_torch.ops.kalman_soa import (
    CtcrwFusedCore,
    CtcrwPlainCore,
    prepare_ctcrw_data,
)


CTCRW_KERNELS = ("ctcrw_filter_totals", "block_prefix_filter",
                 "ctcrw_filter_scan", "ctcrw_smooth_totals",
                 "block_prefix_smooth", "ctcrw_score_scan")
DIAG_KERNELS = ("diag_filter_totals", "block_prefix_diag_filter",
                "diag_filter_scan", "diag_smooth_totals",
                "block_prefix_diag_smooth", "diag_score_scan")


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
    want = {k: int(k in CTCRW_KERNELS) for k in cf.LAUNCHES}
    assert cf.LAUNCHES == want, cf.LAUNCHES
    rv, rg, rgh = _value_grad(CtcrwPlainCore, obs, times, ids, par,
                              torch.float64, cuda)
    assert cf.LAUNCHES == want, "plain path launched"
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


@pytest.mark.gpu
def test_launch_rejects_dtype_mismatch(cuda):
    """Every pointer argument is checked: a float64 output behind a
    float32 input raises instead of being read as float32."""
    from smoothsde_tpu_torch.ops import _kernels

    tot = torch.zeros((5, 8), device=cuda)
    with pytest.raises(TypeError, match="float64"):
        _kernels.launch("block_prefix_diag_filter", tot,
                        tot.to(torch.float64), 2, 4, 0)
    with pytest.raises(TypeError, match="contiguous"):
        _kernels.launch("block_prefix_diag_filter", tot,
                        torch.zeros((8, 5), device=cuda).T, 2, 4, 0)


def test_launch_checks_arguments_before_building(monkeypatch):
    """A CPU tensor handed to the launcher raises TypeError before the
    library is built or loaded (runs without a card or a toolkit)."""
    from smoothsde_tpu_torch.ops import _kernels

    def no_build():
        raise AssertionError("the launcher tried to build the kernels")

    monkeypatch.setattr(_kernels, "build", no_build)
    monkeypatch.setattr(_kernels, "_lib", None)
    tot = torch.zeros((5, 8))
    with pytest.raises(TypeError, match="CUDA"):
        _kernels.launch("block_prefix_diag_filter", tot, tot, 2, 4, 0)
    with pytest.raises(TypeError, match="arguments"):
        _kernels.launch("block_prefix_diag_filter", tot, tot, 2, 4)


def _diag_data(typ, d, n, seed):
    obs, times, ids, par = _data(d, n, seed)
    obs[n // 2] = np.nan  # a whole NaN row
    k = 1 if typ == "BM_SSM" else 2
    rng = np.random.default_rng(seed + 1)
    par = np.column_stack([par[:, :d]] + [
        np.log(0.7) + 0.3 * rng.normal(size=n) for _ in range(k)
    ])
    return obs, times, ids, par


def _diag_value_grad(core, typ, obs, times, ids, par, dtype, device):
    data = df.prepare_diag_data(typ, obs, times, ids, dtype=dtype,
                                device=device)
    p = torch.tensor(par, dtype=dtype, device=device, requires_grad=True)
    s = torch.tensor(0.2, dtype=dtype, device=device, requires_grad=True)
    v = df.diag_fused_loglik(
        df.diag_system(typ, p, None, None, None, s, data=data), core
    )
    v.backward()
    return (v.item(), p.grad.double().cpu().numpy(), s.grad.item())


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
@pytest.mark.parametrize("d,n", [(1, 80), (2, 5000), (3, 20001)])
def test_diag_kernels_match_plain_f64(cuda, typ, d, n):
    """BM_SSM / OU_SSM through DiagFusedCore vs DiagPlainCore: value rtol
    1e-10, gradient 1e-8 of the largest component; each diag kernel
    launched once per direction, and no CTCRW kernel."""
    obs, times, ids, par = _diag_data(typ, d, n, 10 * d + 1)
    cf.reset_launches()
    v, g, gs = _diag_value_grad(df.DiagFusedCore, typ, obs, times, ids, par,
                                torch.float64, cuda)
    want = {k: int(k in DIAG_KERNELS) for k in cf.LAUNCHES}
    assert cf.LAUNCHES == want, cf.LAUNCHES
    rv, rg, rgs = _diag_value_grad(df.DiagPlainCore, typ, obs, times, ids,
                                   par, torch.float64, cuda)
    assert cf.LAUNCHES == want, "plain path launched"
    assert v == pytest.approx(rv, rel=1e-10)
    np.testing.assert_allclose(g, rg, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(rg)))
    assert gs == pytest.approx(rgs, rel=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
def test_diag_f32_kernels_within_accuracy_bar(cuda, typ):
    """f32 kernels vs the f64 plain version: value within 1e-4 relative,
    the per-column gradient within 1e-4 of its largest component."""
    obs, times, ids, par = _diag_data(typ, 2, 50000, 17)
    v, g, _ = _diag_value_grad(df.DiagFusedCore, typ, obs, times, ids, par,
                               torch.float32, cuda)
    rv, rg, _ = _diag_value_grad(df.DiagPlainCore, typ, obs, times, ids, par,
                                 torch.float64, cuda)
    g, rg = g.sum(0), rg.sum(0)
    assert v == pytest.approx(rv, rel=1e-4)
    assert np.max(np.abs(g - rg)) <= 1e-4 * np.max(np.abs(rg))
