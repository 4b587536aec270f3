"""The CTCRW slice end to end: the same small data through both
packages' `SDE(...).fit()`.

Two tracks (n = 400), NaN rows, irregular steps, intercept formulas plus
a linear covariate on tau; f64, the port on the CPU (plain versions of
the kernels). Optimum parameters within 1e-4 absolute, nllk within 1e-8
relative, `cov_fixed` within 1e-3 relative, and `from_reference`
reproduces the JAX `joint_nllk` at the JAX optimum to 1e-10;
`smoothed_states()` at the same parameters agrees with the JAX
package's to 1e-10. A smooth on tau gives the JAX package's Laplace
marginal (value 1e-7 relative, gradient 1e-6).
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.params import from_reference
from smoothsde_tpu_torch.utils.misc import ctcrw_cov

FORMULAS = {"mu1": "~1", "mu2": "~1", "tau": "~x", "nu": "~1"}
PAR0 = [0.0, 0.0, 2.0, 0.8]


def _simulate(seed=7, n_per=(220, 180), tau=3.0, nu=1.0, sobs=0.1):
    rng = np.random.default_rng(seed)
    beta = 1.0 / tau
    sigma = 2.0 * nu / np.sqrt(np.pi * tau)
    cols = {"ID": [], "time": [], "y1": [], "y2": [], "x": []}
    for k, n in enumerate(n_per):
        times = np.cumsum(rng.uniform(0.3, 1.2, size=n))
        v, z = np.zeros(2), np.zeros(2)
        obs = np.zeros((n, 2))
        for i in range(1, n):
            dt = times[i] - times[i - 1]
            e = np.exp(-beta * dt)
            V = ctcrw_cov(beta, sigma, dt)
            for d in range(2):
                mean = [e * v[d], z[d] + v[d] / beta * (1 - e)]
                v[d], z[d] = rng.multivariate_normal(mean, V)
            obs[i] = z + rng.normal(size=2) * sobs
        obs[rng.integers(1, n, size=6)] = np.nan
        cols["ID"] += [k] * n
        cols["time"] += times.tolist()
        cols["y1"] += obs[:, 0].tolist()
        cols["y2"] += obs[:, 1].tolist()
        cols["x"] += rng.normal(size=n).tolist()
    return {k: np.asarray(v) for k, v in cols.items()}


@pytest.fixture(scope="module")
def fits():
    data = _simulate()
    kw = dict(formulas=FORMULAS, data=data, type="CTCRW",
              response=["y1", "y2"], par0=PAR0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_sde = JaxSDE(**kw)
        jax_res = jax_sde.fit()
    port_sde = SDE(**kw, device="cpu", dtype=torch.float64)
    port_res = port_sde.fit()
    return jax_sde, jax_res, port_sde, port_res


def test_optimum_matches_jax(fits):
    _, jr, ps, pr = fits
    assert jr.convergence == 0 and pr.convergence == 0
    assert pr.par_names == jr.par_names
    np.testing.assert_allclose(pr.par, jr.par, rtol=0, atol=1e-4)
    assert pr.value == pytest.approx(jr.value, rel=1e-8)
    # response-scale parameters through the port's own API
    tau_hat = ps.par(t=0)[0, 2]
    assert 1.0 < tau_hat < 10.0


def test_cov_fixed_matches_jax(fits):
    _, jr, _, pr = fits
    np.testing.assert_allclose(pr.cov_fixed, jr.cov_fixed, rtol=1e-3)


def test_from_reference_reproduces_joint_nllk(fits):
    js, jr, ps, _ = fits
    jb = js.bundle()
    full_jax = jb.packer.unpack(jr.par, jb.packer.inner_init())
    ref = float(jax.jit(jb.joint_nllk)(full_jax))
    full = from_reference({k: np.asarray(v) for k, v in full_jax.items()})
    got = float(ps.bundle().joint_nllk(full))
    assert got == pytest.approx(ref, rel=1e-10)


def test_outside_the_slice_raises():
    """Formerly refused (ROADMAP queue 1 item 5): a CTCRW with a user H,
    given in the reference's (m, m, n) layout, or a user P0 builds on the
    generic route (H fixes sigma_obs) and gives the JAX package's joint
    nllk at the start to 1e-10 relative; formerly refused (ROADMAP queue
    1 item 6), fit(mesh="auto") on the CPU (one shard) reaches the flat
    fit's optimum."""
    data = _simulate(n_per=(30,))
    H = np.tile(np.diag([0.01, 0.02])[:, :, None], (1, 1, 30))
    for other in ({"H": H}, {"P0": np.diag([1.0, 4.0, 2.0, 8.0])}):
        kw = dict(data=data, type="CTCRW", response=["y1", "y2"],
                  other_data=other)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jb = JaxSDE(**kw).bundle()
        pb = SDE(**kw, device="cpu", dtype=torch.float64).bundle()
        outer = pb.packer.outer_init()
        assert pb.packer.n_outer == jb.packer.n_outer
        want = float(jb.joint_nllk(jb.packer.unpack(outer)))
        got = float(pb.joint_nllk(pb.packer.unpack(torch.tensor(outer))))
        assert got == pytest.approx(want, rel=1e-10)
    kw = dict(data=data, type="CTCRW", response=["y1", "y2"], device="cpu",
              dtype=torch.float64)
    sharded = SDE(**kw).fit(mesh="auto", compute_sdreport=False)
    flat = SDE(**kw).fit(compute_sdreport=False)
    assert sharded.value == pytest.approx(flat.value, rel=1e-10)
    np.testing.assert_allclose(sharded.par, flat.par, rtol=0, atol=1e-6)


def test_smooth_marginal_matches_jax():
    """Formerly refused (ROADMAP queue 1 item 2): `tau ~ s(x, k=5)` on
    two short tracks through the Laplace marginal."""
    from test_torch_ssm_laplace import assert_marginals_match, marginal_pair

    kw = dict(formulas={"mu1": "~1", "mu2": "~1", "tau": "~s(x, k=5)",
                        "nu": "~1"},
              data=_simulate(n_per=(30, 25)), type="CTCRW",
              response=["y1", "y2"], par0=PAR0)
    assert_marginals_match(*marginal_pair(kw))


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    data = _simulate(n_per=(30,))
    with pytest.raises(RuntimeError, match="cuda"):
        SDE(data=data, type="CTCRW", response=["y1", "y2"])


def test_smoothed_states_match_jax(fits):
    """At the JAX optimum (the port's fit result carrying the JAX
    estimates): means and covariances to 1e-10 of their scale, through
    the port's scan="auto" (the plain blocked scan on the CPU)."""
    js, jr, ps, pr = fits
    jm, jc = js.smoothed_states()
    ps._fit_result = dataclasses.replace(pr, par=np.asarray(jr.par))
    try:
        means, covs = ps.smoothed_states()
    finally:
        ps._fit_result = pr
    assert means.shape == jm.shape == (2, 400, 2)
    assert covs.shape == jc.shape == (2, 400, 2, 2)
    for got, want in ((means, jm), (covs, jc)):
        scale = np.max(np.abs(want))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * scale)
    own_means, _ = ps.smoothed_states()  # at the port's own optimum
    assert np.max(np.abs(own_means - jm)) < 1e-2


def test_smoothed_states_outside_ctcrw_raise():
    data = _simulate(n_per=(30,))
    sde = SDE(data=data, type="CTCRW", response=["y1", "y2"], device="cpu",
              dtype=torch.float64)
    with pytest.raises(RuntimeError, match="Fit model first"):
        sde.smoothed_states()
    bm = SDE(data={"ID": data["ID"], "time": data["time"], "y": data["y1"]},
             type="BM_SSM", response="y", device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="CTCRW"):
        bm.smoothed_states()
