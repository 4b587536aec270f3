"""ESEAL_SSM (the elephant-seal body-condition model) on the port against
the JAX package, in f64 on the CPU.

- the inverse-gamma prior terms: `_dinvgamma_log` against the JAX
  function and scipy, and the prior's share of the joint nllk for the
  three `priors` forms ("schick2013", None, a dict) against scipy, as
  tests/test_models_fit.py holds the JAX package; a bad form raises;
- short-track fits (two tracks of 60 dives, a1 and log_a2 pinned as in
  the JAX package's recovery test; the default priors and none) against
  the JAX fits: estimates within 1e-4, nllk within 1e-8 relative, the
  filtered states within 1e-10 and the whitened residuals within 1e-8;
- a checkpoint of the port's fit loads into the JAX package with the
  ESEAL parameters (log_tau, a1, log_a2) and gives its nllk.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from scipy import stats
from test_models_fit import _eseal_sim

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu.infer.objective import _dinvgamma_log as jax_dinvgamma
from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.objective import _dinvgamma_log

F64 = torch.float64
N = 120
MAP = {"a1": [True], "log_a2": [True]}


def _data():
    data, other = _eseal_sim(n=N)
    data = dict(data, ID=(np.arange(N) >= N // 2).astype(int))
    return data, other


def _kw(priors="schick2013"):
    data, other = _data()
    od = dict(other) if priors == "schick2013" else {**other,
                                                    "priors": priors}
    return dict(data=data, type="ESEAL_SSM", response="z", other_data=od,
                par0=[0.0, 0.3])


def test_dinvgamma_log_matches_jax_and_scipy():
    x = np.array([0.05, 0.3, 1.7, 12.0])
    for shape, scale in ((3.0, 0.5), (10.0 * N, 4.0 * (10.0 * N - 1.0)),
                         (N / 2.0, N / 2.0 - 1.0)):
        got = _dinvgamma_log(torch.tensor(x, dtype=F64), shape, scale)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jax_dinvgamma(jnp.asarray(x), shape,
                                                  scale)),
            rtol=1e-12)
        np.testing.assert_allclose(
            got.numpy(), stats.invgamma.logpdf(x, shape, scale=scale),
            rtol=1e-10)


@pytest.mark.parametrize("priors", ["schick2013", "custom"])
def test_prior_share_of_the_nllk_matches_scipy(priors):
    """The joint nllk with priors minus without is minus the prior
    log-densities at the start (sigma = 0.3, tau = 1)."""
    custom = {"sigma2": (3.0, 0.5)}
    kw = _kw(custom if priors == "custom" else "schick2013")
    b_p = SDE(**kw, device="cpu", dtype=F64).setup()
    b_n = SDE(**_kw(None), device="cpu", dtype=F64).setup()
    full = b_p.packer.unpack(torch.tensor(b_p.packer.outer_init()),
                             torch.tensor(b_p.packer.inner_init()))
    diff = float(b_p.joint_nllk(full) - b_n.joint_nllk(full))
    tau = float(torch.exp(full["log_tau"][0]))
    if priors == "custom":
        lp = stats.invgamma.logpdf(0.3**2, 3.0, scale=0.5)
    else:
        lp = stats.invgamma.logpdf(0.3**2, 10.0 * N,
                                   scale=4.0 * (10.0 * N - 1.0)) + \
            stats.invgamma.logpdf(tau**2, N / 2.0, scale=N / 2.0 - 1.0)
    assert diff == pytest.approx(-lp, rel=1e-10)


def test_bad_priors_raise():
    with pytest.raises(ValueError, match="priors"):
        SDE(**_kw("bogus"), device="cpu", dtype=F64).setup()


@pytest.fixture(scope="module", params=["schick2013", None],
                ids=["schick2013", "no_priors"])
def fits(request):
    kw = _kw(request.param)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JaxSDE(**kw)
        jr = js.fit(map=MAP, compute_sdreport=False)
    ps = SDE(**kw, device="cpu", dtype=F64)
    pr = ps.fit(map=MAP, compute_sdreport=False)
    return js, jr, ps, pr


def test_fit_matches_jax(fits):
    js, jr, ps, pr = fits
    assert jr.convergence == 0 and pr.convergence == 0
    assert pr.par_names == list(jr.par_names)
    assert "log_tau" in pr.par_names
    np.testing.assert_allclose(pr.par, np.asarray(jr.par), rtol=0, atol=1e-4)
    assert pr.value == pytest.approx(float(jr.value), rel=1e-8)
    np.testing.assert_allclose(ps.par(t="all"), np.asarray(js.par(t="all")),
                               rtol=1e-4, atol=1e-6)


def test_states_and_residuals_match_jax(fits):
    js, _, ps, _ = fits
    want = np.asarray(js.filtered_states())
    got = ps.filtered_states()
    assert got.shape == want.shape == (N, 2)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    r, jr = ps.residuals(), np.asarray(js.residuals())
    np.testing.assert_array_equal(np.isnan(r), np.isnan(jr))
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-8, equal_nan=True)


def test_checkpoint_carries_the_eseal_parameters(fits, tmp_path):
    js, _, ps, pr = fits
    path = str(tmp_path / "eseal.npz")
    ps.save_state(path)
    z = np.load(path)
    assert "log_tau" in [str(s) for s in z["fit_par_names"]]
    back = JaxSDE(**_kw(ps.other_data().get("priors", "schick2013")))
    back.load_state(path)
    np.testing.assert_array_equal(np.asarray(back.out().par), pr.par)
    b = back.setup(map=MAP)
    full = b.packer.unpack(jnp.asarray(pr.par), jnp.asarray(pr.bhat))
    assert float(b.joint_nllk(full)) == pytest.approx(pr.value, rel=1e-8)
