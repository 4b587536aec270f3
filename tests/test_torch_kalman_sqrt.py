"""The port's square-root filter (ops/kalman_sqrt.py) against the JAX
package, in f64 on the CPU.

- `_combine_sqrt2` / `_combine_sqrt1` on random factors, and with zero
  factors (the masked and padding elements), equal the JAX combines to
  1e-12, and `_tria24` of zero rows is zero;
- `ctcrw_loglik_sqrt` and `diag_ssm_loglik_sqrt` (BM_SSM, OU_SSM) on every
  scan ("sequential", "blocked", "associative", "auto", "pallas")
  against the JAX function with scan="sequential": value within 1e-10
  relative, gradient in the parameter matrix and sigma_obs within 1e-8 of
  the largest component (JAX reference gradients from its sequential
  scan: XLA:CPU miscompiles reverse-mode associative scans); and against
  the moment-form filter of the same data;
- "pallas" on CPU tensors (the plain versions of K8 and K2) equals
  "blocked" to 1e-12. (The kernels and their refusal of a gradient are
  held on the card: tests/test_torch_gpu.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops import kalman_sqrt as jsq
from smoothsde_tpu_torch.ops import kalman_sqrt as tsq
from smoothsde_tpu_torch.ops.kalman_soa import (
    ctcrw_loglik_soa,
    diag_ssm_loglik_soa,
)

F64 = torch.float64
SCANS = ["sequential", "blocked", "associative", "auto", "pallas"]


def _rand_elem2(rng, shape, zero=False):
    def r(scale=1.0):
        return rng.normal(size=shape) * scale

    def lower():  # a lower-triangular factor with a positive diagonal
        if zero:
            return (np.zeros(shape),) * 3
        return (np.abs(r()) + 0.1, r(0.5), np.abs(r()) + 0.1)

    return jsq.SqrtElement2(A=((r(), r()), (r(), r())), b=(r(), r()),
                            U=lower(), eta=(r(), r()), Z=lower())


def _flat(e):
    return np.stack([np.asarray(x) for x in jax.tree.leaves(e)])


def _to_torch(e):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), e)


def _torch_flat(e):
    return np.stack([x.numpy() for x in
                     jax.tree.leaves(e, is_leaf=torch.is_tensor)])


@pytest.mark.parametrize("zero", [(False, False), (True, False),
                                  (False, True), (True, True)],
                         ids=["factors", "zero-earlier", "zero-later",
                              "zero-both"])
def test_combine_sqrt2_matches_jax(zero):
    rng = np.random.default_rng(3)
    e1, e2 = (_rand_elem2(rng, (64,), z) for z in zero)
    want = _flat(jsq._combine_sqrt2(jax.tree.map(jnp.asarray, e1),
                                    jax.tree.map(jnp.asarray, e2)))
    e1t = tsq.SqrtElement2(*_to_torch(tuple(e1)))
    e2t = tsq.SqrtElement2(*_to_torch(tuple(e2)))
    got = _torch_flat(tuple(tsq._combine_sqrt2(e1t, e2t)))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("zero", [False, True], ids=["factors", "zero"])
def test_combine_sqrt1_matches_jax(zero):
    rng = np.random.default_rng(4)

    def elem():
        A, b, eta = rng.normal(size=(3, 64))
        u, z = (np.zeros(64), np.zeros(64)) if zero else \
            np.abs(rng.normal(size=(2, 64))) + 0.1
        return (A, b, u, eta, z)

    e1, e2 = elem(), elem()
    want = np.stack([np.asarray(x) for x in jsq._combine_sqrt1(
        jsq.SqrtElement1(*map(jnp.asarray, e1)),
        jsq.SqrtElement1(*map(jnp.asarray, e2)))])
    got = torch.stack(list(tsq._combine_sqrt1(
        tsq.SqrtElement1(*map(torch.tensor, e1)),
        tsq.SqrtElement1(*map(torch.tensor, e2))))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_zero_rows_and_guards():
    """`_sdiv(0, 0)` is 0, `_ssqrt` of a non-positive value 0 with a
    finite gradient, and the LQ of zero rows is zero."""
    z = torch.zeros(3, dtype=F64, requires_grad=True)
    assert torch.equal(tsq._sdiv(z, z), torch.zeros(3, dtype=F64))
    out = tsq._ssqrt(z - 1.0) + tsq._ssqrt(z)
    (g,) = torch.autograd.grad(out.sum(), z)
    assert torch.equal(out.detach(), torch.zeros(3, dtype=F64))
    assert bool(torch.isfinite(g).all())
    rows = (z.detach(),) * 4
    assert all(float(v.abs().max()) == 0.0 for v in tsq._tria24(rows, rows))


def _data(d, seed, n_per=(40, 25, 31)):
    """Three tracks (restarting clocks), NaN rows, and a per-step
    working-scale parameter matrix (mu, log tau, log nu / log sigma /
    log tau, log kappa)."""
    rng = np.random.default_rng(seed)
    times = np.concatenate([np.cumsum(rng.uniform(0.05, 0.8, size=k))
                            for k in n_per])
    ids = np.repeat(np.arange(len(n_per)), n_per)
    n = len(ids)
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.4, axis=0)
    obs[rng.integers(1, n, size=4)] = np.nan
    par = np.column_stack([0.2 * rng.normal(size=(n, d)),
                           np.log(2.0) + 0.3 * rng.normal(size=n),
                           np.log(0.8) + 0.3 * rng.normal(size=n)])
    return obs, times, ids, par


def _jax_value_grad(fn, par, sobs):
    v, (gp, gs) = jax.value_and_grad(fn, argnums=(0, 1))(
        jnp.asarray(par), jnp.asarray(sobs))
    return float(v), np.concatenate([np.asarray(gp).ravel(), [float(gs)]])


def _port_value_grad(fn, par, sobs):
    p = torch.tensor(par, dtype=F64, requires_grad=True)
    s = torch.tensor(sobs, dtype=F64, requires_grad=True)
    v = fn(p, s)
    gp, gs = torch.autograd.grad(v, (p, s))
    return float(v.detach()), np.concatenate([gp.numpy().ravel(),
                                              [float(gs)]])


def _assert_match(got, want):
    (v, g), (jv, jg) = got, want
    assert v == pytest.approx(jv, rel=1e-10)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-8 * np.abs(jg).max())


@pytest.mark.parametrize("d", [1, 2])
def test_ctcrw_loglik_sqrt_matches_jax(d):
    obs, times, ids, par = _data(d, seed=d)
    want = _jax_value_grad(
        lambda p, s: jsq.ctcrw_loglik_sqrt(p, obs, times, ids, s,
                                           scan="sequential"), par, 0.2)
    for scan in SCANS:
        got = _port_value_grad(
            lambda p, s: tsq.ctcrw_loglik_sqrt(p, obs, times, ids, s,
                                               scan=scan), par, 0.2)
        _assert_match(got, want)
    moment = ctcrw_loglik_soa(torch.tensor(par), obs, times, ids, 0.2,
                              scan="sequential")
    assert want[0] == pytest.approx(float(moment), rel=1e-10)


@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
def test_diag_ssm_loglik_sqrt_matches_jax(typ):
    obs, times, ids, par = _data(2, seed=7)
    par = par if typ == "OU_SSM" else par[:, :3]
    want = _jax_value_grad(
        lambda p, s: jsq.diag_ssm_loglik_sqrt(typ, p, obs, times, ids, s,
                                              scan="sequential"), par, 0.3)
    for scan in SCANS:
        got = _port_value_grad(
            lambda p, s: tsq.diag_ssm_loglik_sqrt(typ, p, obs, times, ids, s,
                                                  scan=scan), par, 0.3)
        _assert_match(got, want)
    moment = diag_ssm_loglik_soa(typ, torch.tensor(par), obs, times, ids,
                                 0.3, scan="sequential")
    assert want[0] == pytest.approx(float(moment), rel=1e-10)


def test_pallas_equals_blocked_on_cpu():
    """On CPU tensors "pallas" takes the plain versions of K8 and K2
    (`sqrt2`, `sqrt1`): the "blocked" scan's values."""
    obs, times, ids, par = _data(2, seed=11, n_per=(300, 120))
    p = torch.tensor(par)
    for fn in (lambda s: tsq.ctcrw_loglik_sqrt(p, obs, times, ids, 0.2,
                                               scan=s),
               lambda s: tsq.diag_ssm_loglik_sqrt("OU_SSM", p, obs, times,
                                                  ids, 0.2, scan=s)):
        assert float(fn("pallas")) == pytest.approx(float(fn("blocked")),
                                                    rel=1e-12)
