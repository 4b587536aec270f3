"""The port's sequential Kalman filter, step builders and scalar-state
SoA filter against the JAX package, in f64 on the CPU.

- models/ssm.py: the per-dim `ctcrw_steps_perdim` /
  `diag_ssm_steps_perdim`, from the times or from the host intervals
  (`dt`, as the objective builds them), equal the JAX builders' arrays
  to 1e-12 (d in {1, 2}, 3 tracks with restarting clocks, NaN rows);
- ops/kalman.py: `kalman_loglik_sequential` on one dim's steps and
  `kalman_loglik_batched` on the per-dim steps, as they are and batched
  by track (`track_pad_plan` / `batch_steps_by_track`): value within
  1e-10 relative and gradient in the parameter matrix and sigma_obs
  within 1e-8 of the JAX sequential filter's; the track plan equals the
  JAX plan;
- ops/kalman_soa.py `diag_ssm_loglik_soa` on each scan ("blocked",
  "associative", "sequential", "auto") against the JAX function
  (scan="sequential", the XLA:CPU-safe reference), value and gradient,
  at the same bars;
- the twin's routes are transformable: a jvp of the gradient of the
  batched filter equals a central difference of the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.models import ssm as jssm
from smoothsde_tpu.ops import kalman as jk
from smoothsde_tpu.ops.kalman_soa import diag_ssm_loglik_soa as jax_diag_soa
from smoothsde_tpu_torch.models import ssm as tssm
from smoothsde_tpu_torch.ops import kalman as tk
from smoothsde_tpu_torch.ops.kalman_soa import (
    diag_ssm_loglik_soa,
    precompute_dt,
)

F64 = torch.float64
N_PAR = {"BM_SSM": 1, "OU_SSM": 2, "CTCRW": 2}  # parameters after the mus


def _data(typ, d, seed, n_per=(14, 9, 12)):
    """Three tracks (each clock restarting at 0), two NaN rows, and a
    per-step working-scale parameter matrix near the models' scales."""
    rng = np.random.default_rng(seed)
    times = np.concatenate([np.cumsum(rng.uniform(0.2, 0.9, size=k))
                            for k in n_per])
    ids = np.repeat(np.arange(len(n_per)), n_per)
    n = len(ids)
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.5, axis=0)
    obs[[3, n - 5]] = np.nan
    par = np.column_stack(
        [0.2 * rng.normal(size=(n, d))]
        + [np.log(1.5) + 0.3 * rng.normal(size=n)
           for _ in range(N_PAR[typ])])
    return obs, times, ids, par


def _jax_steps(typ, par, obs, times, ids, sobs):
    p, o, t, i = (jnp.asarray(x) for x in (par, obs, times, ids))
    if typ == "CTCRW":
        return jssm.ctcrw_steps_perdim(p, o, t, i, sigma_obs=sobs)
    return jssm.diag_ssm_steps_perdim(typ, p, o, t, i, sigma_obs=sobs)


def _port_steps(typ, par, obs, times, ids, sobs, dt=None):
    if typ == "CTCRW":
        return tssm.ctcrw_steps_perdim(par, obs, times, ids, sigma_obs=sobs,
                                       dt=dt)
    return tssm.diag_ssm_steps_perdim(typ, par, obs, times, ids,
                                      sigma_obs=sobs, dt=dt)


CASES = [(typ, d) for typ in ("BM_SSM", "OU_SSM", "CTCRW") for d in (1, 2)]
IDS = [f"{typ}-d{d}" for typ, d in CASES]


@pytest.mark.parametrize("dt", ["times", "host"])
@pytest.mark.parametrize("typ,d", CASES, ids=IDS)
def test_step_builders_match_jax(typ, d, dt):
    obs, times, ids, par = _data(typ, d, seed=d)
    want = _jax_steps(typ, par, obs, times, ids, 0.3)
    got = _port_steps(typ, torch.tensor(par, dtype=F64), obs, times, ids,
                      torch.tensor(0.3, dtype=F64),
                      precompute_dt(times, ids) if dt == "host" else None)
    for name, g, w in zip(tk.KalmanSteps._fields, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy().astype(w.dtype), w, rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def _jax_value_grad(typ, par, obs, times, ids, sobs, dim=None, plan=None):
    def llk(p, s):
        steps = _jax_steps(typ, p, obs, times, ids, s)
        if dim is not None:
            return jk.kalman_loglik_sequential(
                jk.KalmanSteps(*(x[dim] for x in steps)))[0]
        if plan is not None:
            steps = jk.batch_steps_by_track(steps, *plan)
        return jk.kalman_loglik_batched(steps, impl="sequential")

    v, (gp, gs) = jax.value_and_grad(llk, argnums=(0, 1))(
        jnp.asarray(par), jnp.asarray(sobs))
    return float(v), np.concatenate([np.asarray(gp).ravel(), [float(gs)]])


def _port_value_grad(typ, par, obs, times, ids, sobs, dim=None, plan=None):
    p = torch.tensor(par, dtype=F64, requires_grad=True)
    s = torch.tensor(sobs, dtype=F64, requires_grad=True)
    steps = _port_steps(typ, p, obs, times, ids, s)
    if dim is not None:
        v = tk.kalman_loglik_sequential(
            tk.KalmanSteps(*(x[dim] for x in steps)))
    else:
        if plan is not None:
            steps = tk.batch_steps_by_track(steps, *plan)
        v = tk.kalman_loglik_batched(steps)
    gp, gs = torch.autograd.grad(v, (p, s))
    return float(v.detach()), np.concatenate([gp.numpy().ravel(),
                                              [float(gs)]])


def _assert_match(got, want):
    (v, g), (jv, jg) = got, want
    assert v == pytest.approx(jv, rel=1e-10)
    np.testing.assert_allclose(g, jg, rtol=0,
                               atol=1e-8 * max(1.0, np.abs(jg).max()))


@pytest.mark.parametrize("form", ["last_dim", "perdim", "by_track"])
@pytest.mark.parametrize("typ,d", CASES, ids=IDS)
def test_sequential_filter_matches_jax(typ, d, form):
    """`last_dim`: the unbatched filter on the last dim's steps alone."""
    obs, times, ids, par = _data(typ, d, seed=10 + d)
    dim = d - 1 if form == "last_dim" else None
    jplan = jk.track_pad_plan(ids) if form == "by_track" else None
    tplan = tk.track_pad_plan(ids) if form == "by_track" else None
    want = _jax_value_grad(typ, par, obs, times, ids, 0.25, dim, jplan)
    got = _port_value_grad(typ, par, obs, times, ids, 0.25, dim, tplan)
    _assert_match(got, want)


def test_track_plan_matches_jax():
    for n_per in ((14, 9, 12), (5, 5), (30,), (40, 2, 2)):
        ids = np.repeat(np.arange(len(n_per)), n_per)
        want = jk.track_pad_plan(ids)
        got = tk.track_pad_plan(ids)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scan", ["blocked", "associative", "sequential",
                                  "auto"])
@pytest.mark.parametrize("typ,d", [("BM_SSM", 1), ("BM_SSM", 2),
                                   ("OU_SSM", 1), ("OU_SSM", 2)])
def test_diag_ssm_loglik_soa_matches_jax(typ, d, scan):
    obs, times, ids, par = _data(typ, d, seed=20 + d, n_per=(70, 33, 45))

    def jfn(p, s):
        return jax_diag_soa(typ, p, jnp.asarray(obs), jnp.asarray(times),
                            jnp.asarray(ids), s, scan="sequential")

    jv, (jgp, jgs) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(par), jnp.asarray(0.3))
    p = torch.tensor(par, dtype=F64, requires_grad=True)
    s = torch.tensor(0.3, dtype=F64, requires_grad=True)
    v = diag_ssm_loglik_soa(typ, p, obs, times, ids, s, scan=scan)
    gp, gs = torch.autograd.grad(v, (p, s))
    _assert_match(
        (float(v.detach()),
         np.concatenate([gp.numpy().ravel(), [float(gs)]])),
        (float(jv), np.concatenate([np.asarray(jgp).ravel(), [float(jgs)]])))


@pytest.mark.parametrize("typ", ["CTCRW", "OU_SSM"])
def test_batched_filter_forward_over_reverse(typ):
    """The twin's transform: jvp of the gradient (what jacfwd of grad
    runs) against a central difference of the gradient."""
    obs, times, ids, par = _data(typ, 2, seed=30)
    plan = tk.track_pad_plan(ids)
    base = torch.tensor(par, dtype=F64)
    direction = torch.tensor(np.random.default_rng(31).normal(
        size=par.shape), dtype=F64)

    def llk(p):
        steps = _port_steps(typ, p, obs, times, ids,
                            torch.tensor(0.3, dtype=F64))
        return tk.kalman_loglik_batched(tk.batch_steps_by_track(steps,
                                                                *plan))

    g = torch.func.grad(llk)
    _, hv = torch.func.jvp(g, (base,), (direction,))
    eps = 1e-5
    fd = (g(base + eps * direction) - g(base - eps * direction)) / (2 * eps)
    np.testing.assert_allclose(hv.numpy(), fd.numpy(), rtol=0,
                               atol=1e-6 * max(1.0, float(fd.abs().max())))
