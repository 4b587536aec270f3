"""PyTorch port vs JAX package: the element-space CTCRW path.

The port's `ctcrw_loglik_soa` over every scan x analytic_grad pair (on
CPU tensors the kernel wrappers run their plain versions: K4a/K4b and
K5a/K5b of the fused path, K8 of the "pallas" scan, K2) against JAX
`ctcrw_loglik_soa(scan="sequential")` and `jax.grad`; the element-space
`llk2_analytic(sys, "fused")` and its cotangents against `jax.vjp` of
JAX `llk2_analytic(sys, "sequential")`. Two or three tracks, NaN rows,
per-step varying parameters, d in {1, 2, 3}, several lanes per dim and
lengths that are not a multiple of the steps per lane (so the identity
padding is exercised). f64: value rtol 1e-10, gradient 1e-8 of the
largest component. Also pins the element-space stacks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops import kalman_smooth as jks
from smoothsde_tpu.ops.kalman_soa import _ctcrw_system as jax_system
from smoothsde_tpu.ops.kalman_soa import ctcrw_loglik_soa as jax_loglik
from smoothsde_tpu_torch.ops import ctcrw_fused as tcf
from smoothsde_tpu_torch.ops import kalman_smooth as tks
from smoothsde_tpu_torch.ops.kalman_soa import _ctcrw_system, ctcrw_loglik_soa

CASES = [(1, 80, 3), (2, 700, 2), (3, 333, 3)]  # (d, n, tracks)
SCANS = ["fused", "pallas", "blocked", "sequential", "associative", "auto"]


def _data(d, n, n_tracks, seed):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.2, 1.5, size=n))
    ids = np.sort(rng.integers(0, n_tracks, size=n))
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[rng.integers(1, n, size=max(2, n // 40))] = np.nan
    if d > 1:  # NaN only in a later column: still an update step
        obs[n // 2, 1] = np.nan
    par = np.column_stack([
        0.1 * rng.normal(size=(n, d)),
        np.log(2.0) + 0.3 * rng.normal(size=n),
        np.log(0.8) + 0.3 * rng.normal(size=n),
    ])
    return obs, times, ids, par


@functools.lru_cache(maxsize=None)
def _case(d, n, n_tracks):
    """The data and the JAX reference (value, d/d par, d/d sigma_obs)."""
    obs, times, ids, par = _data(d, n, n_tracks, seed=n + d)

    def f(p, s):
        return jax_loglik(p, obs, times, ids, s, scan="sequential")

    v, (gp, gs) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(par), 0.2)
    return (obs, times, ids, par), (float(v), np.asarray(gp), float(gs))


def _assert_match(got, ref):
    v, gp, gs = got
    rv, rgp, rgs = ref
    assert v == pytest.approx(rv, rel=1e-10)
    scale = np.max(np.abs(rgp))
    np.testing.assert_allclose(gp, rgp, rtol=1e-8, atol=1e-8 * scale)
    assert gs == pytest.approx(rgs, rel=1e-8)


def _port(fn, par):
    p = torch.tensor(par, requires_grad=True)
    s = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    v = fn(p, s)
    v.backward()
    return float(v.detach()), p.grad.numpy(), float(s.grad)


@pytest.mark.parametrize("analytic_grad", [False, True])
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("d,n,tracks", CASES)
def test_loglik_matches_jax(d, n, tracks, scan, analytic_grad):
    (obs, times, ids, par), ref = _case(d, n, tracks)
    p = tcf.plan(d, n)
    assert p.NB > 1 and p.NB * p.L > n  # several lanes, padded

    def f(pt, s):
        return ctcrw_loglik_soa(pt, obs, times, ids, s, scan=scan,
                                analytic_grad=analytic_grad)

    _assert_match(_port(f, par), ref)


@pytest.mark.parametrize("d,n,tracks", CASES)
def test_llk2_fused_matches_jax(d, n, tracks):
    """The element-space Fisher-identity core with the fused kernels'
    plain versions (forward K4a, K2, K4b; backward K5a, K2, K5b), which
    `ctcrw_loglik_soa` reaches only without analytic_grad, at the
    parameter level."""
    (obs, times, ids, par), ref = _case(d, n, tracks)

    def f(pt, s):
        return tks.llk2_analytic(_ctcrw_system(pt, obs, times, ids, s),
                                 "fused")

    _assert_match(_port(f, par), ref)


@pytest.mark.parametrize("scan", ["fused", "sequential"])
@pytest.mark.parametrize("d,n,tracks", CASES)
def test_backward_cotangents_match_jax(d, n, tracks, scan):
    """Element-space cotangents of (Ft, ct, Qt, yd, h) from the fused
    backward and from the port's own score form (scan="sequential")
    against jax.vjp of JAX llk2_analytic(sys, "sequential"). The fused
    backward returns zeros for F[0][0] and F[1][0] (neither reaches a
    parameter), so those are compared for the sequential route only."""
    (obs, times, ids, par), _ = _case(d, n, tracks)
    js = jax_system(jnp.asarray(par), obs, times, ids, 0.2)

    def f(Ft, ct, Qt, yd, h):
        return jks.llk2_analytic(
            js._replace(Ft=Ft, ct=ct, Qt=Qt, yd=yd, h=h), "sequential")

    jv, vjp = jax.vjp(f, js.Ft, js.ct, js.Qt, js.yd, js.h)
    jFb, jcb, jQb, jyb, jhb = vjp(1.0)

    sys = _ctcrw_system(torch.tensor(par), obs, times, ids, 0.2)
    leaves = {
        "f00": sys.Ft[0][0], "f01": sys.Ft[0][1], "f10": sys.Ft[1][0],
        "f11": sys.Ft[1][1], "c0": sys.ct[0], "c1": sys.ct[1],
        "q00": sys.Qt[0][0], "q01": sys.Qt[0][1], "q11": sys.Qt[1][1],
        "y": sys.yd, "h": sys.h,
    }
    L = {k: v.detach().clone().requires_grad_(True)
         for k, v in leaves.items()}
    sys = sys._replace(
        Ft=((L["f00"], L["f01"]), (L["f10"], L["f11"])),
        ct=(L["c0"], L["c1"]),
        # the primal's Q[0][1] and Q[1][0] are one tensor: its cotangent
        # is the sum of the two entries'
        Qt=((L["q00"], L["q01"]), (L["q01"], L["q11"])),
        yd=L["y"], h=L["h"],
    )
    v = tks.llk2_analytic(sys, scan)
    grads = dict(zip(L, torch.autograd.grad(v, list(L.values()))))
    assert float(v.detach()) == pytest.approx(float(jv), rel=1e-10)
    want = {
        "f01": jFb[0][1], "f11": jFb[1][1], "c0": jcb[0], "c1": jcb[1],
        "q00": jQb[0][0], "q01": np.asarray(jQb[0][1]) + np.asarray(jQb[1][0]),
        "q11": jQb[1][1], "y": jyb, "h": jhb,
    }
    if scan != "fused":
        want.update(f00=jFb[0][0], f10=jFb[1][0])
    for k, w in want.items():
        w = np.asarray(w)
        got = grads[k].numpy()
        assert got.shape == w.shape, k
        scale = max(np.max(np.abs(w)), 1e-300)
        np.testing.assert_allclose(got, w, rtol=1e-8, atol=1e-8 * scale,
                                   err_msg=k)


def test_kernel_wrappers_equal_plain_on_cpu():
    """On CPU tensors the element-space wrappers run their plain versions:
    identical results, and no launch is counted."""
    (obs, times, ids, par), _ = _case(*CASES[1])
    sys = _ctcrw_system(torch.tensor(par), obs, times, ids, 0.2)
    tcf.reset_launches()
    out = []
    for ops in (tcf.ELEM_OPS["kernels"], tcf.ELEM_OPS["plain"]):
        llk, mom = tcf.fused_filter(sys, ops)
        bars = tcf.fused_backward(sys, mom, torch.tensor(1.0, dtype=mom.dtype),
                                  ops)
        out.append([llk, mom, *jax.tree.leaves(bars)])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert all(c == 0 for c in tcf.LAUNCHES.values())


def test_elem_stacks_padding_and_rows():
    """The forward stack holds the entering transition, the backward one
    the leaving transition and the look-ahead masks; padding past n is
    f11 = 1 and zeros elsewhere (identity elements)."""
    d, n = 2, 131
    obs, times, ids, par = _data(d, n, 1, 4)
    ids = np.zeros(n, int)
    ids[40:], ids[97:] = 1, 2
    sys = _ctcrw_system(torch.tensor(par), obs, times, ids, 0.3)
    p = tcf.plan(d, n)
    assert p.NB * p.L > n
    stacks = {"fwd": tcf.elem_forward_stack(sys, p),
              "bwd": tcf.elem_backward_stack(sys, p)}
    reset = np.concatenate([[True], ids[1:] != ids[:-1]])
    prev = np.concatenate([[True], reset[:-1]])
    f01 = sys.Ft[0][1].numpy()
    want_fwd = {0: f01, 1: sys.Ft[1][1].numpy(), 8: reset,
                9: np.isfinite(obs[:, 0]) & ~reset}
    want_bwd = {0: np.append(f01[1:], 0.0),
                1: np.append(sys.Ft[1][1].numpy()[1:], 1.0),
                7: np.append(reset[1:], True),
                8: np.append((~reset & ~prev)[1:], False), 11: reset}
    for key, want, pads in (("fwd", want_fwd, tcf._ELEM_FWD_PAD),
                            ("bwd", want_bwd, tcf._ELEM_BWD_PAD)):
        stack = stacks[key]
        rows = tcf.unstack(stack, p).numpy()
        for i, w in want.items():
            np.testing.assert_array_equal(rows[i], np.broadcast_to(w, (d, n)))
        k = stack.shape[1]
        full = stack.reshape(p.L, k, d, p.NB).permute(1, 2, 3, 0)
        tail = full.reshape(k, d, -1)[:, :, n:]
        for i, v in enumerate(pads):
            assert torch.all(tail[i] == v)
