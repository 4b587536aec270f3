"""The closed-form transition densities and the stable log-Bessel-I of
the port against the JAX package, in f64 on the CPU.

Densities: each `*_logdens` and `closed_form_loglik` on seeded data with
NaN values and whole NaN rows over two tracks: values within 1e-12
relative, gradients in the parameter matrix within 1e-10.
`log_besselI` / `log_besselI_scaled` on a grid that crosses the series,
Hankel and Olver branches (x from 1e-3 to 500, q from -0.5 to 30):
values within 1e-12 relative, first derivatives in x and q within 1e-10,
second derivatives (torch.func.hessian against jax.hessian) within 1e-8.
And the f32 per-term precision of the scaled-Bessel CIR form
(tests/test_densities.py's check, on the port's `cir_logdens`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops import besseli as jbes
from smoothsde_tpu.ops import densities as jden
from smoothsde_tpu_torch.ops import besseli as tbes
from smoothsde_tpu_torch.ops import densities as tden
from smoothsde_tpu_torch.ops.kalman_soa import precompute_dt

TYPES = ("BM", "BM_t", "OU", "CIR")
OTHER = {"BM_t": {"df": 5.0}}
F64 = torch.float64


def _n_par(typ, d):
    return d + (1 if typ in ("BM", "BM_t") else 2)


def _steps(typ, seed=0, n=60):
    """(Z1, Z0, dt, par) for one density: positive values (CIR's
    domain), parameters varying per step."""
    rng = np.random.default_rng(seed)
    d = 1 if typ == "BM_t" else 2
    Z0 = rng.uniform(0.5, 3.0, size=(n, d))
    Z1 = rng.uniform(0.5, 3.0, size=(n, d))
    dt = rng.uniform(0.1, 1.5, size=n)
    par = rng.normal(size=(n, _n_par(typ, d))) * 0.3
    return Z1, Z0, dt, par


def _track_data(typ, seed=1, n=80):
    """Two tracks, a NaN value in one dim and a whole NaN row."""
    rng = np.random.default_rng(seed)
    d = 1 if typ == "BM_t" else 2
    obs = rng.uniform(0.5, 3.0, size=(n, d))
    obs[7, 0] = np.nan
    obs[33, :] = np.nan
    times = np.cumsum(rng.uniform(0.1, 1.0, size=n))
    ids = (np.arange(n) >= 45).astype(int)
    par = rng.normal(size=(n, _n_par(typ, d))) * 0.3
    return obs, times, ids, par


@pytest.mark.parametrize("typ", TYPES)
def test_logdens_matches_jax(typ):
    Z1, Z0, dt, par = _steps(typ)
    other = OTHER.get(typ)
    jfn = jden.CLOSED_FORM_LOGDENS[typ]
    want = np.asarray(jfn(jnp.asarray(Z1), jnp.asarray(Z0), jnp.asarray(dt),
                          jnp.asarray(par), other))
    jgrad = np.asarray(jax.grad(
        lambda p: jnp.sum(jfn(jnp.asarray(Z1), jnp.asarray(Z0),
                              jnp.asarray(dt), p, other)))(jnp.asarray(par)))
    pt = torch.tensor(par, dtype=F64, requires_grad=True)
    got = tden.CLOSED_FORM_LOGDENS[typ](
        torch.tensor(Z1, dtype=F64), torch.tensor(Z0, dtype=F64),
        torch.tensor(dt, dtype=F64), pt, other)
    (g,) = torch.autograd.grad(got.sum(), pt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(g.numpy(), jgrad, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("precomputed_dt", [False, True],
                         ids=["times", "host_dt"])
@pytest.mark.parametrize("typ", TYPES)
def test_closed_form_loglik_matches_jax(typ, precomputed_dt):
    obs, times, ids, par = _track_data(typ)
    other = OTHER.get(typ)
    dt = precompute_dt(times, ids) if precomputed_dt else None

    def jfn(p):
        return jden.closed_form_loglik(typ, jnp.asarray(obs),
                                       jnp.asarray(times), jnp.asarray(ids),
                                       p, other, dt=dt)

    want = float(jfn(jnp.asarray(par)))
    jgrad = np.asarray(jax.grad(jfn)(jnp.asarray(par)))
    pt = torch.tensor(par, dtype=F64, requires_grad=True)
    got = tden.closed_form_loglik(typ, obs, times, ids, pt, other, dt=dt)
    (g,) = torch.autograd.grad(got, pt)
    assert np.isfinite(want)
    assert float(got) == pytest.approx(want, rel=1e-12)
    assert np.all(np.isfinite(g.numpy()))
    np.testing.assert_allclose(g.numpy(), jgrad, rtol=1e-10, atol=1e-10)
    # the prepared-data form, as the objective calls it
    data = tden.prepare_closed_form_data(obs, times, ids, dtype=F64,
                                         device="cpu",
                                         dt=precompute_dt(times, ids))
    got2 = tden.closed_form_loglik(typ, None, None, None, pt.detach(), other,
                                   data=data)
    assert float(got2) == pytest.approx(want, rel=1e-12)


# the grid crosses all three branches: series (q < 8, x < 100), Hankel
# (q < 8, x >= 100) and Olver (q >= 8)
XS = np.array([1e-3, 0.05, 1.0, 7.5, 42.0, 99.5, 100.5, 180.0, 500.0])
QS = np.array([-0.5, -0.2, 0.0, 0.7, 3.3, 7.9, 8.1, 11.8, 30.0])
BESSEL = ("log_besselI", "log_besselI_scaled")


def _grid():
    Q, X = np.meshgrid(QS, XS)
    return X.reshape(-1), Q.reshape(-1)


@pytest.mark.parametrize("name", BESSEL)
def test_besseli_values_and_first_derivatives_match_jax(name):
    x, q = _grid()
    jfn, tfn = getattr(jbes, name), getattr(tbes, name)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(q)))
    jgx, jgq = (np.asarray(a) for a in jax.grad(
        lambda a, b: jnp.sum(jfn(a, b)), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(q)))
    xt = torch.tensor(x, dtype=F64, requires_grad=True)
    qt = torch.tensor(q, dtype=F64, requires_grad=True)
    got = tfn(xt, qt)
    gx, gq = torch.autograd.grad(got.sum(), (xt, qt))
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(gx.numpy(), jgx, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gq.numpy(), jgq, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", BESSEL)
def test_besseli_second_derivatives_match_jax(name):
    x, q = _grid()
    xq = np.stack([x, q], axis=1)
    jfn, tfn = getattr(jbes, name), getattr(tbes, name)
    want = np.asarray(jax.vmap(jax.hessian(lambda v: jfn(v[0], v[1])))(
        jnp.asarray(xq)))
    got = torch.func.vmap(torch.func.hessian(lambda v: tfn(v[0], v[1])))(
        torch.tensor(xq, dtype=F64)).numpy()
    assert got.shape == want.shape == (len(x), 2, 2)
    scale = np.maximum(np.abs(want), 1.0)
    assert np.max(np.abs(got - want) / scale) < 1e-8


def test_besseli_zero_argument():
    assert float(tbes.log_besselI(0.0, 0.0)) == 0.0
    assert np.isneginf(float(tbes.log_besselI(0.0, 1.0)))
    assert np.isneginf(float(tbes.log_besselI_scaled(0.0, 2.5)))


def test_cir_f32_per_term_precision():
    """The scaled-Bessel CIR form keeps the per-term f32 error ~1e-6 in
    the large-argument regime (x ~ 300), where the naive -u-v+log I form
    loses ~1e-4 a term: a bias that sums to O(100) nllk units at 1M
    steps. Bars as the JAX package's own check."""
    rng = np.random.default_rng(6)
    n = 20000
    dt = 0.1
    mu_t, beta_t, sigma_t = 2.0, 0.8, 0.5
    c = 2 * beta_t / (sigma_t**2 * (1 - np.exp(-beta_t * dt)))
    df = 4 * beta_t * mu_t / sigma_t**2
    ebd = np.exp(-beta_t * dt)
    z = np.empty(n)
    z[0] = mu_t
    for i in range(1, n):
        z[i] = rng.noncentral_chisquare(df, 2 * c * z[i - 1] * ebd) / (2 * c)
    Z0, Z1 = z[:-1, None], z[1:, None]
    dts = np.full(n - 1, dt)
    par = np.tile([np.log(mu_t), np.log(beta_t), np.log(sigma_t)], (n - 1, 1))

    def terms(dtype):
        return tden.cir_logdens(
            *(torch.tensor(a, dtype=dtype) for a in (Z1, Z0, dts, par))
        )[:, 0].double().numpy()

    err = terms(torch.float32) - terms(F64)
    assert abs(err.mean()) < 2e-6, err.mean()
    assert err.std() < 1e-5, err.std()
