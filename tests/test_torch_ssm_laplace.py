"""The state-space Laplace layer against the JAX package, in f64 on the
CPU: CTCRW with `tau ~ s(ID, bs='re')`, BM_SSM with `sigma ~ s(ID,
bs='re')`, OU_SSM with `tau ~ s(x, k=5)`, and the BM_SSM one under REML.

- the forward-mode twin (`joint_nllk_ad`, on the CPU the sequential
  filter batched by track) equals the kernel path's plain version
  (`joint_nllk`) to 1e-10, and so do the SoA scans the twin takes on a
  card ("associative", "blocked"; and "sequential"), value and gradient
  in the parameter matrix;
- the Laplace marginal (value term on the kernel path, every
  second-order quantity on the twin) against the JAX marginal: value
  within 1e-7 relative, gradient within 1e-6;
- (the small fits of the same cases: tests/test_torch_ssm_fit.py);
- the f32 marginal stays f32 (no promotion under jvp-of-grad) and within
  1e-4 relative of f64's;
- config 4's golden point (tests/golden/config4.npz, 8 x 250 steps): the
  joint nllk within 1e-8 and the marginal within test_golden.py's bars
  (test_torch_ssm_laplace_marginal.py, with the CTCRW and REML
  marginals).
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu.infer.laplace import make_laplace as jax_make_laplace
from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.laplace import make_laplace
from smoothsde_tpu_torch.infer.objective import build_objective
from smoothsde_tpu_torch.ops.diag_fused import diag_ssm_loglik_fused
from smoothsde_tpu_torch.ops.kalman_soa import (
    ctcrw_loglik_soa,
    diag_ssm_loglik_soa,
)
from smoothsde_tpu_torch.utils.misc import ctcrw_cov

ROOT = os.path.join(os.path.dirname(__file__), "..")
F64 = torch.float64


def _tracks(typ, seed, n_id=4, n_per=16, spread=0.5, sobs=0.1):
    """n_id tracks with a per-track scale exp(spread z_k) (of tau for
    CTCRW, of sigma for BM_SSM) or a tau varying in a covariate x
    (OU_SSM), restarting clocks, a NaN row a track, noise sd sobs."""
    rng = np.random.default_rng(seed)
    cols = {"ID": [], "time": [], "y1": [], "y2": [], "x": []}
    for k in range(n_id):
        t = np.cumsum(rng.uniform(0.3, 0.8, size=n_per))
        x = rng.uniform(0, 1, size=n_per)
        state = np.zeros((n_per, 2))
        scale = np.exp(spread * rng.normal())
        v = np.zeros(2)
        for i in range(1, n_per):
            dt = t[i] - t[i - 1]
            if typ == "CTCRW":
                tau = 3.0 * scale
                beta, sigma = 1 / tau, 2 / np.sqrt(np.pi * tau)
                e = np.exp(-beta * dt)
                V = ctcrw_cov(beta, sigma, dt)
                for d in range(2):
                    mean = [e * v[d], state[i - 1, d] + v[d] / beta * (1 - e)]
                    v[d], state[i, d] = rng.multivariate_normal(mean, V)
            elif typ == "BM_SSM":
                state[i] = state[i - 1] + 0.1 * dt + 0.5 * scale * np.sqrt(
                    dt) * rng.normal(size=2)
            else:
                dec = np.exp(-dt / np.exp(0.5 + 1.5 * np.sin(6 * x[i - 1])))
                state[i] = dec * state[i - 1] + np.sqrt(1 - dec**2) * \
                    rng.normal(size=2)
        obs = state + sobs * rng.normal(size=(n_per, 2))
        obs[rng.integers(1, n_per)] = np.nan
        cols["ID"] += [f"a{k}"] * n_per
        cols["time"] += t.tolist()
        cols["y1"] += obs[:, 0].tolist()
        cols["y2"] += obs[:, 1].tolist()
        cols["x"] += x.tolist()
    return {k: np.asarray(v) for k, v in cols.items()}


CASES = {
    "ctcrw_tau_re": ("CTCRW", {"mu1": "~1", "mu2": "~1",
                               "tau": "~s(ID, bs='re')", "nu": "~1"},
                     [0.0, 0.0, 2.0, 0.8], "ML"),
    "bm_ssm_sigma_re": ("BM_SSM", {"mu1": "~1", "mu2": "~1",
                                   "sigma": "~s(ID, bs='re')"},
                        None, "ML"),
    "ou_ssm_tau_smooth": ("OU_SSM", {"mu1": "~1", "mu2": "~1",
                                     "tau": "~s(x, k=5)", "kappa": "~1"},
                          None, "ML"),
    "bm_ssm_reml": ("BM_SSM", {"mu1": "~1", "mu2": "~1",
                               "sigma": "~s(ID, bs='re')"}, None, "REML"),
}


# each type's data (the REML case shares BM_SSM's): an interior optimum
DATA = {"CTCRW": dict(seed=2, n_id=6, n_per=20, spread=1.0),
        "BM_SSM": dict(seed=15),
        "OU_SSM": dict(seed=17, n_id=3, n_per=40, sobs=0.3)}


def _kw(case):
    typ, formulas, par0, _ = CASES[case]
    return dict(formulas=formulas, data=_tracks(typ, **DATA[typ]),
                type=typ, response=["y1", "y2"], par0=par0)


def _point(packer, seed):
    rng = np.random.default_rng(seed)
    return (packer.outer_init() + 0.1 * rng.normal(size=packer.n_outer),
            0.1 * rng.normal(size=packer.n_inner))


def _loglik(typ, pm, sde, sobs, scan):
    """The state-space log-likelihood of the parameter matrix pm through
    the kernel path's plain version (scan "fused") or an SoA scan."""
    args = (pm, sde._obs, sde._times, sde._ids)
    if typ == "CTCRW":
        return ctcrw_loglik_soa(*args, sigma_obs=sobs, scan=scan,
                                analytic_grad=scan == "fused")
    if scan == "fused":
        return diag_ssm_loglik_fused(typ, *args, sigma_obs=sobs)
    return diag_ssm_loglik_soa(typ, *args, sigma_obs=sobs, scan=scan)


@pytest.mark.parametrize("route", ["track", "associative", "blocked",
                                   "sequential"])
@pytest.mark.parametrize("case", ["ctcrw_tau_re", "bm_ssm_sigma_re",
                                  "ou_ssm_tau_smooth"])
def test_twin_equals_kernel_path(case, route):
    sde = SDE(**_kw(case), device="cpu", dtype=F64)
    b = build_objective(sde._spec, sde._design, sde._obs, sde._times,
                        sde._ids, dtype=F64, device="cpu")
    assert b.twin == "track"
    outer, inner = _point(b.packer, 1)
    full = b.packer.unpack(torch.tensor(outer), torch.tensor(inner))
    want = float(b.joint_nllk(full))
    assert b.joint_nllk_ad_flat is b.joint_nllk_ad
    if route == "track":
        assert float(b.joint_nllk_ad(full)) == pytest.approx(want, rel=1e-10)
        unpenalized = float(b.joint_nllk_unpenalized(full))
        assert np.isfinite(unpenalized) and unpenalized != want
        return
    typ = CASES[case][0]
    pm = b.par_matrix(full).detach().requires_grad_(True)
    sobs = torch.exp(full["log_sigma_obs"][0]).detach()
    kv = _loglik(typ, pm, sde, sobs, "fused")
    (kg,) = torch.autograd.grad(kv, pm)
    tv = _loglik(typ, pm, sde, sobs, route)
    (tg,) = torch.autograd.grad(tv, pm)
    assert float(tv) == pytest.approx(float(kv), rel=1e-10)
    np.testing.assert_allclose(tg.numpy(), kg.numpy(), rtol=0,
                               atol=1e-8 * max(1.0, float(kg.abs().max())))


def marginal_pair(kw, reml=False, seed=2):
    """(JAX value, JAX gradient, port value, port gradient) of the
    Laplace marginal at a point near the start, both packages' SDE built
    from the keyword arguments `kw`."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jb = JaxSDE(**kw).setup(reml=reml)
    pb = SDE(**kw, device="cpu", dtype=F64).setup(reml=reml)
    assert pb.packer.outer_names() == jb.packer.outer_names()
    assert pb.packer.inner_names() == jb.packer.inner_names()
    outer, _ = _point(jb.packer, seed)
    jm = jax_make_laplace(jb.joint_nllk, jb.packer,
                          joint_nllk_ad=jb.joint_nllk_ad,
                          hess_plan=jb.hess_plan)
    (jv, _), jg = jax.value_and_grad(jm, has_aux=True)(
        jnp.asarray(outer), jnp.asarray(jb.packer.inner_init()))
    pm = make_laplace(pb.joint_nllk, pb.packer,
                      joint_nllk_ad=pb.joint_nllk_ad, hess_plan=pb.hess_plan)
    xt = torch.tensor(outer, requires_grad=True)
    v, _ = pm(xt, torch.tensor(pb.packer.inner_init()))
    (g,) = torch.autograd.grad(v, xt)
    return float(jv), np.asarray(jg), float(v.detach()), g.numpy()


# the other two cases and config 4's golden point are in
# test_torch_ssm_laplace_marginal.py (xdist's loadfile puts a file on one
# worker, and each marginal takes a minute or two on the CPU)
@pytest.mark.parametrize("case", ["bm_ssm_sigma_re", "ou_ssm_tau_smooth"])
def test_marginal_matches_jax(case):
    check_marginal(case)


def check_marginal(case):
    assert_marginals_match(*marginal_pair(_kw(case),
                                          CASES[case][3] == "REML"))


def assert_marginals_match(jv, jg, v, g):
    assert v == pytest.approx(jv, rel=1e-7)
    np.testing.assert_allclose(g, jg, rtol=1e-6,
                               atol=1e-6 * max(1.0, np.abs(jg).max()))


def test_f32_marginal_stays_f32():
    kw = _kw("ctcrw_tau_re")
    outs = {}
    for dtype in (torch.float32, F64):
        b = SDE(**kw, device="cpu", dtype=dtype).setup()
        outer, _ = _point(b.packer, 3)
        m = make_laplace(b.joint_nllk, b.packer,
                         joint_nllk_ad=b.joint_nllk_ad)
        xt = torch.tensor(outer, dtype=dtype, requires_grad=True)
        v, bhat = m(xt, torch.zeros(b.packer.n_inner, dtype=dtype))
        (g,) = torch.autograd.grad(v, xt)
        assert v.dtype == bhat.dtype == g.dtype == dtype
        outs[dtype] = float(v.detach())
    assert outs[torch.float32] == pytest.approx(outs[F64], rel=1e-4)
