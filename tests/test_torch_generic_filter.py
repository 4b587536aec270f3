"""The port's full-state step builders and generic Kalman filters against
the JAX package, in f64 on the CPU.

- models/ssm.py: `bm_ssm_steps`, `ou_ssm_steps`, `ctcrw_steps` (with and
  without a user observation covariance H (n, m, m) and a user P0) and
  `eseal_ssm_steps` equal the JAX builders' arrays to 1e-12, as do the
  per-dim builders with a user P0;
- ops/kalman.py: `kalman_loglik(impl="parallel" | "sequential")`,
  `kalman_loglik_sequential(with_states=True)`, `kalman_filter_parallel`
  with `filtered_to_reported_states`, and `kalman_innovations` on both
  routes against the JAX sequential scan: values within 1e-10 relative,
  states and innovations within 1e-10 of their scale, gradients in the
  parameter matrix within 1e-8 of the largest component (JAX reference
  gradients from its sequential scan: XLA:CPU miscompiles reverse-mode
  associative scans); the parallel filter is torch.func-transformable
  (a jvp of its gradient equals a central difference of the gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.models import ssm as jssm
from smoothsde_tpu.ops import kalman as jk
from smoothsde_tpu_torch.models import ssm as tssm
from smoothsde_tpu_torch.ops import kalman as tk

F64 = torch.float64
N_PAR = {"BM_SSM": 1, "OU_SSM": 2, "CTCRW": 2, "ESEAL_SSM": 0}


def _argos_H(n, d, rng):
    """Per-row Argos-style error covariances: semi-axes and orientation
    drawn per row (d = 2), a diagonal for other d."""
    if d != 2:
        return np.stack([np.diag(v) for v in rng.uniform(0.05, 0.3,
                                                         size=(n, d))])
    a, b = rng.uniform(0.1, 0.5, size=n), rng.uniform(0.02, 0.1, size=n)
    th = rng.uniform(0, np.pi, size=n)
    c, s = np.cos(th), np.sin(th)
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return R @ (np.stack([a**2, b**2], -1)[..., None] * np.eye(2)) @ \
        np.swapaxes(R, -1, -2)


def _data(typ, d, seed, n_per=(13, 8, 11)):
    """Three tracks (each clock restarting at 0), two NaN rows, a
    per-step working-scale parameter matrix near the models' scales, a
    per-row H and a P0."""
    rng = np.random.default_rng(seed)
    times = np.concatenate([np.cumsum(rng.uniform(0.2, 0.9, size=k))
                            for k in n_per])
    ids = np.repeat(np.arange(len(n_per)), n_per)
    n = len(ids)
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.5, axis=0)
    obs[[3, n - 5]] = np.nan
    if typ == "ESEAL_SSM":
        par = np.column_stack([0.05 + 0.02 * rng.normal(size=n),
                               np.log(0.12) + 0.1 * rng.normal(size=n)])
    else:
        par = np.column_stack(
            [0.2 * rng.normal(size=(n, d))]
            + [np.log(1.5) + 0.3 * rng.normal(size=n)
               for _ in range(N_PAR[typ])])
    s = 2 * d if typ == "CTCRW" else 2 if typ == "ESEAL_SSM" else d
    P0 = np.diag(rng.uniform(0.5, 5.0, size=s))
    return obs, times, ids, par, _argos_H(n, d, rng), P0


def _eseal_extra(n, seed):
    rng = np.random.default_rng(seed)
    return dict(log_tau=np.log(0.08), a1=-0.578, log_a2=np.log(1.214),
                h=rng.uniform(50, 150, size=n), R=rng.uniform(8, 12, size=n),
                dep_fat=np.full(n, 60.0) + rng.normal(size=n))


def _steps(mod, typ, par, obs, times, ids, H=None, P0=None, seed=0):
    """The full-state steps of either package (mod: jssm or tssm);
    arrays are cast by the builder."""
    if typ == "ESEAL_SSM":
        ex = _eseal_extra(len(ids), seed)
        return mod.eseal_ssm_steps(par, obs, times, ids, ex["log_tau"],
                                   ex["a1"], ex["log_a2"], ex["h"], ex["R"],
                                   ex["dep_fat"], P0=P0)
    return mod.SSM_STEP_BUILDERS[typ](par, obs, times, ids, sigma_obs=0.3,
                                      H_array=H, P0=P0)


def _jax(typ, par, obs, times, ids, H, P0):
    return _steps(jssm, typ, jnp.asarray(par), jnp.asarray(obs),
                  jnp.asarray(times), jnp.asarray(ids),
                  None if H is None else jnp.asarray(H),
                  None if P0 is None else jnp.asarray(P0))


def _port(typ, par, obs, times, ids, H, P0):
    return _steps(tssm, typ, par, obs, times, ids, H, P0)


CASES = [("BM_SSM", 2), ("OU_SSM", 3), ("CTCRW", 1), ("CTCRW", 2),
         ("ESEAL_SSM", 1)]
IDS = [f"{t}-d{d}" for t, d in CASES]


@pytest.mark.parametrize("user", [False, True], ids=["default", "H_P0"])
@pytest.mark.parametrize("typ,d", CASES, ids=IDS)
def test_full_state_builders_match_jax(typ, d, user):
    obs, times, ids, par, H, P0 = _data(typ, d, seed=d)
    H = H if user and typ != "ESEAL_SSM" else None
    P0 = P0 if user else None
    want = _jax(typ, par, obs, times, ids, H, P0)
    got = _port(typ, torch.tensor(par, dtype=F64), obs, times, ids, H, P0)
    for name, g, w in zip(tk.KalmanSteps._fields, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy().astype(w.dtype), w, rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("typ,d", [("CTCRW", 2), ("OU_SSM", 2)])
def test_perdim_builders_take_P0(typ, d):
    obs, times, ids, par, _, P0 = _data(typ, d, seed=7)
    jp = (jnp.asarray(par), jnp.asarray(obs), jnp.asarray(times),
          jnp.asarray(ids))
    tp = (torch.tensor(par, dtype=F64), obs, times, ids)
    if typ == "CTCRW":
        want = jssm.ctcrw_steps_perdim(*jp, 0.3, P0=jnp.asarray(P0))
        got = tssm.ctcrw_steps_perdim(*tp, 0.3, P0=P0)
    else:
        want = jssm.diag_ssm_steps_perdim(typ, *jp, 0.3, P0=jnp.asarray(P0))
        got = tssm.diag_ssm_steps_perdim(typ, *tp, 0.3, P0=P0)
    for name, g, w in zip(tk.KalmanSteps._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def _jax_value_grad(typ, par, obs, times, ids, H, P0):
    def llk(p):
        return jk.kalman_loglik_sequential(
            _jax(typ, p, obs, times, ids, H, P0))[0]

    v, g = jax.value_and_grad(llk)(jnp.asarray(par))
    return float(v), np.asarray(g)


FILTER_CASES = [("CTCRW", 2, True), ("CTCRW", 1, False), ("OU_SSM", 3, True),
                ("BM_SSM", 2, False), ("ESEAL_SSM", 1, True)]
FILTER_IDS = [f"{t}-d{d}-{'H_P0' if u else 'default'}"
              for t, d, u in FILTER_CASES]


@pytest.mark.parametrize("impl", ["parallel", "sequential"])
@pytest.mark.parametrize("typ,d,user", FILTER_CASES, ids=FILTER_IDS)
def test_kalman_loglik_matches_jax_sequential(typ, d, user, impl):
    obs, times, ids, par, H, P0 = _data(typ, d, seed=10 + d)
    H = H if user and typ != "ESEAL_SSM" else None
    P0 = P0 if user else None
    jv, jg = _jax_value_grad(typ, par, obs, times, ids, H, P0)
    p = torch.tensor(par, dtype=F64, requires_grad=True)
    v = tk.kalman_loglik(_port(typ, p, obs, times, ids, H, P0), impl=impl)
    (g,) = torch.autograd.grad(v, p)
    assert float(v.detach()) == pytest.approx(jv, rel=1e-10)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-8 * np.abs(jg).max())


@pytest.mark.parametrize("typ,d,user", FILTER_CASES, ids=FILTER_IDS)
def test_states_and_innovations_match_jax(typ, d, user):
    """aest_all from the sequential scan (with_states) and from the
    parallel filter's moments (filtered_to_reported_states), and the
    innovations of both routes, against the JAX sequential scans."""
    obs, times, ids, par, H, P0 = _data(typ, d, seed=20 + d)
    H = H if user and typ != "ESEAL_SSM" else None
    P0 = P0 if user else None
    js = _jax(typ, par, obs, times, ids, H, P0)
    jv, want = jk.kalman_loglik_sequential(js, with_states=True)
    ju, jF, jok = (np.asarray(a) for a in jk.kalman_innovations(js))
    ts = _port(typ, torch.tensor(par, dtype=F64), obs, times, ids, H, P0)
    v, seq = tk.kalman_loglik_sequential(ts, with_states=True)
    pv, m_f, _ = tk.kalman_filter_parallel(ts)
    par_states = tk.filtered_to_reported_states(ts, m_f)
    want = np.asarray(want)
    scale = np.abs(want).max()
    for got in (seq, par_states):
        assert tuple(got.shape) == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-10 * scale
    for got in (v, pv):
        assert float(got) == pytest.approx(float(jv), rel=1e-10)
    for impl in ("sequential", "parallel"):
        u, F, ok = tk.kalman_innovations(ts, impl=impl)
        np.testing.assert_array_equal(ok.numpy(), jok)
        for a, b in ((u, ju), (F, jF)):
            assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()


def test_batched_parallel_filter_matches_per_sequence():
    """A leading batch axis (the per-dim factorization) through the
    parallel filter: each sequence's llk equals its own filter's, and
    kalman_loglik_batched sums them."""
    obs, times, ids, par, _, _ = _data("CTCRW", 2, seed=3)
    steps = tssm.ctcrw_steps_perdim(torch.tensor(par, dtype=F64), obs, times,
                                    ids, 0.3)
    each = [tk.kalman_filter_parallel(tk.KalmanSteps(*(x[k] for x in steps)))
            for k in range(2)]
    v, m_f, P_f = tk.kalman_filter_parallel(steps)
    assert tuple(v.shape) == (2,)
    for k in range(2):
        assert float(v[k]) == pytest.approx(float(each[k][0]), rel=1e-12)
        assert torch.allclose(m_f[k], each[k][1], rtol=0, atol=1e-12)
    full = tssm.ctcrw_steps(torch.tensor(par, dtype=F64), obs, times, ids,
                            0.3)
    assert float(tk.kalman_loglik_batched(steps, "parallel")) == \
        pytest.approx(float(tk.kalman_loglik(full, "sequential")), rel=1e-10)


def test_parallel_filter_is_transformable():
    """jvp of the gradient of the parallel filter (what the Laplace layer
    takes of the generic route) equals a central difference of the
    gradient."""
    obs, times, ids, par, H, P0 = _data("CTCRW", 2, seed=5)
    p0 = torch.tensor(par, dtype=F64)

    def f(p):
        return tk.kalman_loglik(_port("CTCRW", p, obs, times, ids, H, P0),
                                impl="parallel")

    v = torch.from_numpy(np.random.default_rng(1).normal(size=par.shape))
    _, hv = torch.func.jvp(torch.func.grad(f), (p0,), (v,))
    eps = 1e-5
    fd = (torch.func.grad(f)(p0 + eps * v) - torch.func.grad(f)(p0 - eps * v)) \
        / (2 * eps)
    assert torch.allclose(hv, fd, rtol=0, atol=1e-6 * float(fd.abs().max()))


def test_unknown_impl_raises():
    obs, times, ids, par, _, _ = _data("BM_SSM", 1, seed=1)
    steps = tssm.bm_ssm_steps(torch.tensor(par, dtype=F64), obs, times, ids,
                              0.3)
    with pytest.raises(ValueError, match="unknown Kalman impl"):
        tk.kalman_loglik(steps, impl="bogus")
    assert tk.default_filter_impl("cpu") == "sequential"
    assert tk.default_filter_impl("cuda") == "parallel"


def _sde_kw(case):
    """A small state-space model on the generic route: a 2-D CTCRW with
    a per-row Argos-style H (sigma_obs then fixed), or a 2-D BM_SSM with
    a user P0 (sigma_obs fitted)."""
    rng = np.random.default_rng(31)
    n_per = (40, 30)
    n = sum(n_per)
    times = np.concatenate([np.cumsum(rng.uniform(0.3, 0.8, size=k))
                            for k in n_per])
    ids = np.repeat([0, 1], n_per)
    H = _argos_H(n, 2, rng)
    x = np.cumsum(rng.normal(size=(n, 2)) * 0.5, axis=0)
    x += np.einsum("nij,nj->ni", np.linalg.cholesky(H),
                   rng.normal(size=(n, 2)))
    x[[5, 50]] = np.nan
    data = {"ID": ids, "time": times, "y1": x[:, 0], "y2": x[:, 1]}
    if case == "ctcrw_H":
        return dict(data=data, type="CTCRW", response=["y1", "y2"],
                    par0=[0.0, 0.0, 2.0, 0.8], other_data={"H": H})
    return dict(data=data, type="BM_SSM", response=["y1", "y2"],
                other_data={"P0": np.diag([4.0, 2.0])})


@pytest.fixture(scope="module", params=["ctcrw_H", "bm_ssm_P0"])
def generic_fits(request):
    import warnings

    from smoothsde_tpu import SDE as JaxSDE
    from smoothsde_tpu_torch import SDE

    kw = _sde_kw(request.param)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JaxSDE(**kw)
        jr = js.fit(compute_sdreport=False)
    ps = SDE(**kw, device="cpu", dtype=F64)
    pr = ps.fit(compute_sdreport=False)
    return js, jr, ps, pr


def test_generic_route_fit_matches_jax(generic_fits):
    """SDE(other_data={"H": ...} | {"P0": ...}).fit() on the port (the
    generic sequential filter on the CPU) against the JAX fit: estimates
    within 1e-4, nllk within 1e-8 relative, sigma_obs fixed under H;
    filtered states within 1e-10 and residuals within 1e-8."""
    js, jr, ps, pr = generic_fits
    assert jr.convergence == 0 and pr.convergence == 0
    assert pr.par_names == list(jr.par_names)
    assert ("log_sigma_obs" in pr.par_names) == (ps.type() != "CTCRW")
    np.testing.assert_allclose(pr.par, np.asarray(jr.par), rtol=0, atol=1e-4)
    assert pr.value == pytest.approx(float(jr.value), rel=1e-8)
    want = np.asarray(js.filtered_states())
    assert np.abs(ps.filtered_states() - want).max() <= \
        1e-10 * np.abs(want).max()
    np.testing.assert_allclose(ps.residuals(), np.asarray(js.residuals()),
                               rtol=0, atol=1e-8, equal_nan=True)
    if ps.type() == "CTCRW":
        with pytest.raises(NotImplementedError, match="isotropic"):
            ps.smoothed_states()
