"""The scalar-state slice end to end: the same small data through both
packages' `SDE(...).fit()`, for BM_SSM and OU_SSM.

Two tracks (n = 300), whole NaN rows, irregular steps, intercept
formulas plus a linear covariate on sigma (BM_SSM) or tau (OU_SSM); f64,
the port on the CPU (plain versions of the kernels; BM_SSM centred on
its observations, as the port's objective does). Optimum parameters
within 1e-4 absolute, nllk within 1e-8 relative, `cov_fixed` within
1e-3 relative, and `from_reference` reproduces the JAX `joint_nllk` at
the JAX optimum to 1e-10. A random effect on sigma (BM_SSM) and a smooth
on tau (OU_SSM) give the JAX package's Laplace marginal (value 1e-7
relative, gradient 1e-6). Types and options outside the slice still
raise.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.params import from_reference

CASES = {
    "BM_SSM": {"mu1": "~1", "mu2": "~1", "sigma": "~x"},
    "OU_SSM": {"mu1": "~1", "mu2": "~1", "tau": "~x", "kappa": "~1"},
}


def _simulate(typ, seed=3, n_per=(160, 140), sobs=0.2):
    rng = np.random.default_rng(seed)
    mu = np.array([1.0, -0.5])
    cols = {"ID": [], "time": [], "y1": [], "y2": [], "x": []}
    for k, n in enumerate(n_per):
        times = np.cumsum(rng.uniform(0.2, 1.0, size=n))
        x = np.zeros((n, 2))
        for i in range(1, n):
            dt = times[i] - times[i - 1]
            if typ == "BM_SSM":  # drift 0.1, sigma 0.5
                x[i] = x[i - 1] + 0.1 * dt + 0.5 * np.sqrt(dt) * rng.normal(
                    size=2)
            else:  # tau 2, kappa 1
                dec = np.exp(-dt / 2.0)
                x[i] = mu + dec * (x[i - 1] - mu) + np.sqrt(
                    1 - dec**2) * rng.normal(size=2)
        obs = x + sobs * rng.normal(size=(n, 2))
        obs[rng.integers(1, n, size=5)] = np.nan
        cols["ID"] += [k] * n
        cols["time"] += times.tolist()
        cols["y1"] += obs[:, 0].tolist()
        cols["y2"] += obs[:, 1].tolist()
        cols["x"] += rng.normal(size=n).tolist()
    return {k: np.asarray(v) for k, v in cols.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def fits(request):
    typ = request.param
    kw = dict(formulas=CASES[typ], data=_simulate(typ), type=typ,
              response=["y1", "y2"])
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
    assert np.all(np.isfinite(ps.par(t="all")))


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


N_OUT = 30  # one track of 30 steps
_HS = np.tile(np.diag([0.04, 0.09]), (N_OUT, 1, 1))
_ESEAL = {"h": np.full(N_OUT, 100.0), "R": np.full(N_OUT, 10.0),
          "dep_fat": np.full(N_OUT, 60.0)}


@pytest.mark.parametrize("typ,resp,kw", [
    ("ESEAL_SSM", "y1", {"other_data": _ESEAL}),
    ("BM_SSM", ["y1", "y2"], {"other_data": {"P0": np.eye(2)}}),
    ("OU_SSM", ["y1", "y2"], {"other_data": {"H": _HS}}),
    ("CTCRW", ["y1", "y2"], {"other_data": {"H": _HS}}),
])
def test_outside_the_slice_raises(typ, resp, kw):
    """Formerly refused (ROADMAP queue 1 item 5): ESEAL_SSM, a user P0
    and a per-row H now build on the generic route, and their joint nllk
    at the start equals the JAX package's to 1e-10 relative."""
    data = _simulate("BM_SSM", n_per=(N_OUT,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jb = JaxSDE(data=data, type=typ, response=resp, **kw).bundle()
    pb = SDE(data=data, type=typ, response=resp, device="cpu",
             dtype=torch.float64, **kw).bundle()
    outer, inner = pb.packer.outer_init(), pb.packer.inner_init()
    np.testing.assert_array_equal(outer, jb.packer.outer_init())
    want = float(jb.joint_nllk(jb.packer.unpack(outer, inner)))
    got = float(pb.joint_nllk(pb.packer.unpack(torch.tensor(outer),
                                               torch.tensor(inner))))
    assert got == pytest.approx(want, rel=1e-10)


@pytest.mark.parametrize("typ,formulas", [
    ("BM_SSM", {"mu1": "~1", "mu2": "~1", "sigma": "~s(ID, bs='re')"}),
    ("OU_SSM", {"mu1": "~1", "mu2": "~1", "tau": "~s(x, k=5)",
                "kappa": "~1"}),
])
def test_inner_coefficients_match_jax(typ, formulas):
    """Formerly refused (ROADMAP queue 1 item 2): the Laplace marginal
    of a random effect or a smooth on three short tracks."""
    from test_torch_ssm_laplace import assert_marginals_match, marginal_pair

    data = _simulate(typ, n_per=(30, 25, 20))
    kw = dict(formulas=formulas, data=data, type=typ, response=["y1", "y2"])
    assert_marginals_match(*marginal_pair(kw))


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    data = _simulate("OU_SSM", n_per=(30,))
    with pytest.raises(RuntimeError, match="cuda"):
        SDE(data=data, type="OU_SSM", response=["y1", "y2"])
