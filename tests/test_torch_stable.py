"""PyTorch port vs JAX package: cancellation-free CTCRW transition terms
(smoothsde_tpu_torch/ops/stable.py vs smoothsde_tpu/ops/stable.py).

The same f64 u-grid, spanning the 0.6 series cutoff and 1e-8 ... 50,
goes through both; every function agrees to rtol 1e-14 (a few ulp: the
two frameworks' expm1/exp may round differently by one ulp, which the
regrouped forms amplify by at most ~10x near the cutoff)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops import stable as jst
from smoothsde_tpu_torch.ops import stable as tst

RTOL = 1e-14


def _u_grid():
    u = np.concatenate([
        np.geomspace(1e-8, 50.0, 400),
        np.linspace(0.55, 0.65, 101),  # both sides of the series cutoff
        [0.6, np.nextafter(0.6, 0.0), np.nextafter(0.6, 1.0)],
    ])
    return np.sort(u)


@pytest.mark.parametrize("name", ["em1", "psi", "phi"])
def test_scalar_functions_match_jax(name):
    u = _u_grid()
    ref = np.asarray(getattr(jst, name)(jnp.asarray(u)))
    got = getattr(tst, name)(torch.tensor(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    # the host-side NumPy route of the same code
    got_np = getattr(tst, name)(u, xp=np)
    np.testing.assert_allclose(got_np, ref, rtol=RTOL, atol=0)


def test_em1_psi_phi_kernel_matches_jax():
    u = _u_grid()
    ref = jst.em1_psi_phi_kernel(jnp.asarray(u))
    got = tst.em1_psi_phi_kernel(torch.tensor(u))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=0)


def test_kernel_forms_match_expm1_forms():
    """The CUDA kernels and their plain versions use expm1-based
    em1/psi/phi; the JAX TPU kernels used the expm1-free forms. The two
    agree to a few ulp across the grid."""
    u = torch.tensor(_u_grid())
    e1, m1, ps, ph = tst.em1_psi_phi_kernel(u)
    np.testing.assert_allclose(m1.numpy(), tst.em1(u).numpy(), rtol=1e-14)
    np.testing.assert_allclose(ps.numpy(), tst.psi(u).numpy(), rtol=1e-14)
    np.testing.assert_allclose(ph.numpy(), tst.phi(u).numpy(), rtol=1e-14)
    np.testing.assert_allclose(e1.numpy(), torch.exp(-u).numpy(), rtol=0)


def test_ctcrw_transition_terms_match_jax():
    rng = np.random.default_rng(0)
    u = _u_grid()
    beta = rng.uniform(0.05, 3.0, size=u.size)
    dt = u / beta
    sigma2 = rng.uniform(0.1, 5.0, size=u.size)
    ref = jst.ctcrw_transition_terms(
        jnp.asarray(beta), jnp.asarray(sigma2), jnp.asarray(dt)
    )
    got = tst.ctcrw_transition_terms(
        torch.tensor(beta), torch.tensor(sigma2), torch.tensor(dt)
    )
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=0, err_msg=k)


def test_taylor_tables_are_verbatim():
    assert tst._PSI_COEFFS == jst._PSI_COEFFS
    assert tst._PHI_COEFFS == jst._PHI_COEFFS
    assert tst._SERIES_CUTOFF == jst._SERIES_CUTOFF


def test_ou_transition_terms_match_jax():
    """decay, drift factor em1(u) and noise factor em1(u)(1 + decay) of
    the OU models, on the same grid of u = dt / tau."""
    rng = np.random.default_rng(1)
    u = _u_grid()
    tau = rng.uniform(0.05, 3.0, size=u.size)
    dt = u * tau
    ref = jst.ou_transition_terms(jnp.asarray(tau), jnp.asarray(dt))
    got = tst.ou_transition_terms(torch.tensor(tau), torch.tensor(dt))
    got_np = tst.ou_transition_terms(tau, dt, xp=np)
    assert set(ref) == set(got) == set(got_np)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=0, err_msg=k)
        np.testing.assert_allclose(got_np[k], np.asarray(ref[k]),
                                   rtol=RTOL, atol=0, err_msg=k)
