"""The closed-form family end to end: the same small data through both
packages' `SDE(...).fit()`, f64, the port on the CPU.

Cases: BM in config 1's shape (tools/bench_configs.py, n = 300); OU with
`s(time, k=6, bs='cs')` on mu and kappa in config 2's shape (n = 400:
the Laplace approximation); CIR (n = 500, the stable log-Bessel-I); BM_t
(df = 5); a BM with a decay-modulated spline on mu; and REML on the OU
smooth (coeff_fe integrated out with coeff_re). Optimum within 1e-4
absolute, nllk within 1e-8 relative, `cov_fixed` within 1e-3 relative,
bhat and lambda within 1e-4; `from_reference` reproduces the JAX
`joint_nllk` at the JAX optimum, and the port's marginal the JAX
marginal there, to 1e-10. A state-space model (BM_SSM) with random
effects, or under REML, gives the JAX package's Laplace marginal (value
1e-7 relative, gradient 1e-6).
"""

import warnings

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.laplace import make_laplace
from smoothsde_tpu_torch.infer.params import from_reference

F64 = torch.float64


def _bm(n=300):
    """Config 1's shape: BM, constant parameters, seed 0."""
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.4, 0.6, size=n))
    dt = np.diff(times)
    z = np.concatenate([[0.0], np.cumsum(
        0.4 * dt + 0.8 * np.sqrt(dt) * rng.normal(size=n - 1))])
    data = {"ID": np.zeros(n, int), "time": times, "z": z}
    return dict(data=data, type="BM", response="z", par0=[0.0, 1.0])


def _ou_smooth(n=400, k=6):
    """Config 2's shape: OU with smooth mean and variance in time."""
    rng = np.random.default_rng(1)
    dt, tau = 0.3, 2.0
    times = np.arange(n) * dt
    mu_t = 1.0 + 0.8 * np.sin(2 * np.pi * times / times[-1])
    kap_t = np.exp(0.5 * np.cos(2 * np.pi * times / times[-1]))
    x = np.empty(n)
    x[0] = mu_t[0]
    e = np.exp(-dt / tau)
    for i in range(1, n):
        x[i] = mu_t[i - 1] + e * (x[i - 1] - mu_t[i - 1]) + rng.normal() * \
            np.sqrt(kap_t[i - 1] * (1 - e * e))
    data = {"ID": np.zeros(n, int), "time": times, "z": x}
    sm = f"~s(time, k={k}, bs='cs')"
    return dict(formulas={"mu": sm, "tau": "~1", "kappa": sm}, data=data,
                type="OU", response="z", par0=[1.0, 1.0, 1.0])


def _cir(n=500):
    """Config 5b's model at a small size: exact noncentral-chi^2 steps."""
    rng = np.random.default_rng(6)
    dt, mu, beta, sigma = 0.1, 2.0, 0.8, 0.5
    c = 2 * beta / (sigma**2 * (1 - np.exp(-beta * dt)))
    df = 4 * beta * mu / sigma**2
    ebd = np.exp(-beta * dt)
    z = np.empty(n)
    z[0] = mu
    for i in range(1, n):
        z[i] = rng.noncentral_chisquare(df, 2 * c * z[i - 1] * ebd) / (2 * c)
    data = {"ID": np.zeros(n, int), "time": np.arange(n) * dt, "z": z}
    return dict(data=data, type="CIR", response="z", par0=[1.5, 1.0, 0.7])


def _bm_t(n=300):
    rng = np.random.default_rng(11)
    dt = rng.uniform(0.3, 0.7, size=n - 1)
    df = 5.0
    steps = 0.2 * dt + 0.5 * np.sqrt(dt) * rng.standard_t(df, size=n - 1) \
        / np.sqrt(df / (df - 2))
    data = {"ID": np.zeros(n, int),
            "time": np.concatenate([[0.0], np.cumsum(dt)]),
            "z": np.concatenate([[0.0], np.cumsum(steps)])}
    return dict(data=data, type="BM_t", response="z", par0=[0.0, 1.0],
                other_data={"df": df})


def _decay(n=300):
    """A decaying-response spline on mu (tests/test_models_fit.py's)."""
    rng = np.random.default_rng(7)
    dt = 0.25
    times = np.arange(n) * dt
    x1 = np.linspace(0, 1, n)
    effect = 0.8 * np.sin(2 * np.pi * x1) * np.exp(-0.05 * times)
    z = np.concatenate([[0.0], np.cumsum(
        effect[:-1] * dt + 0.3 * np.sqrt(dt) * rng.normal(size=n - 1))])
    data = {"ID": np.zeros(n, int), "time": times, "z": z, "x1": x1}
    return dict(formulas={"mu": "~s(x1, k=5, bs='ts')", "sigma": "~1"},
                data=data, type="BM", response="z",
                other_data={"t_decay": np.tile(times, 2),
                            "decay_term": "mu.s(x1)",
                            "ind_decay": [1, 1, 1, 1]})


CASES = {
    "bm": (_bm, "ML"),
    "ou_smooth": (_ou_smooth, "ML"),
    "cir": (_cir, "ML"),
    "bm_t": (_bm_t, "ML"),
    "decay": (_decay, "ML"),
    "ou_reml": (_ou_smooth, "REML"),
}


@pytest.fixture(scope="module", params=list(CASES))
def fits(request):
    make, criterion = CASES[request.param]
    kw = make()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_sde = JaxSDE(**kw)
        jax_res = jax_sde.fit(criterion=criterion)
    port_sde = SDE(**kw, device="cpu", dtype=F64)
    port_res = port_sde.fit(criterion=criterion)
    return jax_sde, jax_res, port_sde, port_res


def test_optimum_matches_jax(fits):
    _, jr, ps, pr = fits
    assert jr.convergence == 0 and pr.convergence == 0
    assert pr.par_names == jr.par_names
    assert pr.inner_names == jr.inner_names
    np.testing.assert_allclose(pr.par, jr.par, rtol=0, atol=1e-4)
    assert pr.value == pytest.approx(jr.value, rel=1e-8)
    assert np.all(np.isfinite(ps.par(t="all")))


def test_cov_fixed_matches_jax(fits):
    _, jr, _, pr = fits
    np.testing.assert_allclose(pr.cov_fixed, jr.cov_fixed, rtol=1e-3)


def test_bhat_lambda_and_decay_match_jax(fits):
    js, jr, ps, pr = fits
    np.testing.assert_allclose(pr.bhat, jr.bhat, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps.coeff_re(), js.coeff_re(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ps.lambda_(), js.lambda_(), rtol=1e-4)
    np.testing.assert_allclose(ps.sdev(), js.sdev(), rtol=1e-4)
    np.testing.assert_allclose(ps.rho(), js.rho(), rtol=1e-4)
    if jr.joint_precision is None:
        assert pr.joint_precision is None
    else:
        assert pr.joint_names == jr.joint_names
        scale = np.max(np.abs(jr.joint_precision))
        np.testing.assert_allclose(pr.joint_precision, jr.joint_precision,
                                   rtol=0, atol=1e-3 * scale)


def test_par_matches_jax(fits):
    """Response-scale parameters at every row, the random-effect part
    included, at each package's own estimates: `js.par` itself, for the
    decay model too (both packages, as the reference, evaluate `par`
    with make_mat's X_re, the decay-modulated columns unscaled)."""
    js, _, ps, _ = fits
    np.testing.assert_allclose(ps.par(t="all"), js.par(t="all"), rtol=1e-4,
                               atol=1e-4)


def test_par_on_a_decay_model_matches_jax_at_a_moderate_rate():
    """At a moderate decay rate set through update_rho, with the same
    coefficients in both packages, the decayed linear predictor differs
    from the undecayed one by more than 1e-3, and the port's `par`
    equals the JAX package's (the undecayed form) to 1e-12."""
    kw = _decay()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JaxSDE(**kw)
    ps = SDE(**kw, device="cpu", dtype=F64)
    rng = np.random.default_rng(4)
    cfe = rng.normal(size=len(js.coeff_fe()))
    cre = rng.normal(size=len(js.coeff_re()))
    for m in (js, ps):
        m.update_coeff_fe(cfe)
        m.update_coeff_re(cre)
        m.update_rho([0.05])
    X_fe = js.mats()["X_fe"]
    decayed = X_fe @ cfe + js.X_re_decay() @ cre
    undecayed = X_fe @ cfe + js.mats()["X_re"] @ cre
    assert np.max(np.abs(decayed - undecayed)) > 1e-3
    np.testing.assert_allclose(ps.X_re_decay(), js.X_re_decay(), rtol=0,
                               atol=1e-12)
    for resp in (True, False):
        np.testing.assert_allclose(ps.par(t="all", resp=resp),
                                   js.par(t="all", resp=resp), rtol=1e-12,
                                   atol=1e-12)


def test_from_reference_reproduces_joint_and_marginal(fits):
    js, jr, ps, _ = fits
    jb = js.bundle()
    full_jax = jb.packer.unpack(jr.par, jr.bhat)
    ref = float(jax.jit(jb.joint_nllk)(full_jax))
    full = from_reference({k: np.asarray(v) for k, v in full_jax.items()})
    pb = ps.bundle()
    assert float(pb.joint_nllk(full)) == pytest.approx(ref, rel=1e-10)
    marginal = make_laplace(pb.joint_nllk, pb.packer)
    val, _ = marginal(torch.tensor(jr.par, dtype=F64),
                      torch.tensor(jr.bhat, dtype=F64))
    assert float(val) == pytest.approx(jr.value, rel=1e-10)


@pytest.mark.parametrize("formulas,criterion", [
    ({"mu": "~1", "sigma": "~s(ID, bs='re')"}, "ML"),
    ({"mu": "~1", "sigma": "~1"}, "REML"),
], ids=["random_effect", "reml"])
def test_state_space_inner_coefficients_raise(formulas, criterion):
    """Once the refusal of these state-space cases (ROADMAP queue 1 item
    2), now their Laplace marginal against the JAX package's."""
    from test_torch_ssm_laplace import assert_marginals_match, marginal_pair

    rng = np.random.default_rng(2)
    n = 60
    data = {"ID": np.repeat([0, 1, 2], 20), "time": np.arange(n) * 0.5,
            "y": np.cumsum(rng.normal(size=n))}
    kw = dict(formulas=formulas, data=data, type="BM_SSM", response="y")
    assert_marginals_match(*marginal_pair(kw, criterion == "REML"))
