"""The port's penalty and Laplace approximation against the JAX package
and the exact Gaussian marginal, in f64 on the CPU.

`make_penalty` with single-matrix and multi-penalty groups, normalized
and not: within 1e-12 of the JAX penalty, gradient too. The Laplace
marginal of BM with `s(ID, bs='re')` on the mean is exact (the model is
linear-Gaussian in coeff_re): the port's marginal within 1e-8 relative of
the analytic marginal of tests/test_laplace.py, its gradient (implicit
bhat, log-det curvature term included) within 1e-7 of `jax.grad` of the
JAX marginal, and bhat within 1e-8 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from test_laplace import _analytic_marginal, _bm_re_setup

from smoothsde_tpu.infer.laplace import make_laplace as jax_make_laplace
from smoothsde_tpu.ops.penalty import make_penalty as jax_make_penalty
from smoothsde_tpu_torch.formula.design import build_design
from smoothsde_tpu_torch.infer.laplace import make_laplace
from smoothsde_tpu_torch.infer.objective import build_objective
from smoothsde_tpu_torch.models.registry import get_model_spec
from smoothsde_tpu_torch.ops.penalty import make_penalty

F64 = torch.float64
OUTERS = ([0.3, -0.2, 0.1], [0.0, 0.0, 0.0], [-0.5, 0.3, 1.0])


def _spd(rng, k, rank=None):
    A = rng.normal(size=(k, rank or k))
    return A @ A.T + (0.0 if rank else 0.5) * np.eye(k)


def _groups(kind):
    rng = np.random.default_rng(4)
    if kind == "single":
        return [[_spd(rng, 4)], [_spd(rng, 3)]]
    # a tensor-product block (two rank-deficient margins: P is SPD only
    # as their sum) beside a single-matrix block
    return [[_spd(rng, 6, rank=4), _spd(rng, 6, rank=4)], [_spd(rng, 3)]]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_penalty_matches_jax(kind, normalize):
    groups = _groups(kind)
    n_lam = sum(len(g) for g in groups)
    p = sum(g[0].shape[0] for g in groups)
    rng = np.random.default_rng(5)
    b, ll = rng.normal(size=p), rng.normal(size=n_lam) * 0.5
    jp = jax_make_penalty(groups, normalize)
    want = float(jp(jnp.asarray(b), jnp.asarray(ll)))
    jgb, jgl = jax.grad(jp, argnums=(0, 1))(jnp.asarray(b), jnp.asarray(ll))
    tp = make_penalty(groups, normalize, dtype=F64, device="cpu")
    bt = torch.tensor(b, dtype=F64, requires_grad=True)
    lt = torch.tensor(ll, dtype=F64, requires_grad=True)
    got = tp(bt, lt)
    gb, gl = torch.autograd.grad(got, (bt, lt))
    assert float(got.detach()) == pytest.approx(want, rel=1e-12, abs=1e-12)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jgl), rtol=1e-12,
                               atol=1e-12)


@pytest.fixture(scope="module")
def bm_re():
    jb, data, obs, times, ids, n_id, n_per = _bm_re_setup()
    design = build_design({"mu": "~s(ID, bs='re')", "sigma": "~1"}, data)
    tb = build_objective(get_model_spec("BM", 1), design, obs[:, None],
                         times, ids, dtype=F64, device="cpu")
    return jb, tb, obs, times, ids, n_id, n_per


def test_marginal_matches_analytic(bm_re):
    _, tb, obs, times, ids, n_id, n_per = bm_re
    assert tb.packer.n_outer == 3 and tb.packer.n_inner == n_id
    marginal = make_laplace(tb.joint_nllk, tb.packer)
    for outer in OUTERS:
        val, _ = marginal(torch.tensor(outer, dtype=F64),
                          torch.zeros(n_id, dtype=F64))
        want = _analytic_marginal(outer, obs, times, ids, n_id, n_per)
        assert float(val) == pytest.approx(want, rel=1e-8)


@pytest.fixture(scope="module")
def jax_marginal_vg(bm_re):
    jb = bm_re[0]
    return jax.jit(jax.value_and_grad(
        jax_make_laplace(jb.joint_nllk, jb.packer), has_aux=True))


@pytest.mark.parametrize("outer", OUTERS, ids=["a", "zero", "b"])
def test_marginal_gradient_and_bhat_match_jax(bm_re, jax_marginal_vg, outer):
    _, tb, *_, n_id, _ = bm_re
    (jv, jbhat), jg = jax_marginal_vg(jnp.asarray(outer, float),
                                      jnp.zeros(n_id))
    marginal = make_laplace(tb.joint_nllk, tb.packer)
    xt = torch.tensor(outer, dtype=F64, requires_grad=True)
    val, bhat = marginal(xt, torch.zeros(n_id, dtype=F64))
    (g,) = torch.autograd.grad(val, xt)
    assert float(val) == pytest.approx(float(jv), rel=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-7,
                               atol=1e-7)
    np.testing.assert_allclose(bhat.numpy(), np.asarray(jbhat), rtol=1e-8,
                               atol=1e-8)
    # bhat is the mode of the joint: its inner gradient vanishes
    gb = torch.func.grad(lambda b: tb.joint_nllk(tb.packer.unpack(
        xt.detach(), b)))(bhat)
    assert float(gb.abs().max()) < 1e-6


def test_marginal_without_inner_is_the_joint():
    jb, data, obs, times, ids, *_ = _bm_re_setup()
    design = build_design({"mu": "~1", "sigma": "~1"}, data)
    tb = build_objective(get_model_spec("BM", 1), design, obs[:, None],
                         times, ids, dtype=F64, device="cpu")
    assert tb.packer.n_inner == 0
    x = torch.tensor([0.3, -0.2], dtype=F64)
    val, bhat = make_laplace(tb.joint_nllk, tb.packer)(x, None)
    assert bhat.numel() == 0
    assert float(val) == float(tb.joint_nllk(tb.packer.unpack(x)))
