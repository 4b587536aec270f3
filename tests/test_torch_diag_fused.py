"""PyTorch port vs JAX package: BM_SSM / OU_SSM log-likelihood and its
gradient through the fused path.

The port's `diag_ssm_loglik_fused` (the autograd.Function over D1a, K2,
D1b forward and D3a, K2, D3b backward; on CPU tensors every kernel
wrapper runs its plain version) against:

- the JAX `diag_ssm_loglik_fused` with its Pallas kernels in interpret
  mode (SMOOTHSDE_PALLAS_INTERPRET=1, as tests/test_kalman.py runs
  them), n = 90, d in {1, 3}, two tracks, a NaN row;
- the JAX `diag_ssm_loglik_soa(scan="sequential")` and `jax.grad` at
  n ~ 700, several blocks per dim and a length that is not a multiple
  of the steps per lane, so the identity padding is exercised.

Per-step varying parameters, value rtol 1e-10, gradient 1e-8 of the
largest component. Also pins the stack layout (per-row pad values, the
look-ahead masks) and the step-by-step oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops.diag_fused import diag_ssm_loglik_fused as jax_fused
from smoothsde_tpu.ops.kalman_soa import diag_ssm_loglik_soa as jax_soa
from smoothsde_tpu_torch.ops import ctcrw_fused as tcf
from smoothsde_tpu_torch.ops import diag_fused as tdf
from smoothsde_tpu_torch.ops.kalman_soa import diag_ssm_loglik_sequential

N_EXTRA = {"BM_SSM": 1, "OU_SSM": 2}


def _data(typ, d, n, seed):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.2, 0.8, size=n))
    ids = np.sort(rng.integers(0, 2, size=n))
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[11] = np.nan
    obs[rng.integers(1, n, size=max(2, n // 60))] = np.nan
    if d > 1:  # NaN only in a later column: still an update step
        obs[n // 2, 1] = np.nan
    par = np.column_stack(
        [0.1 * rng.normal(size=(n, d))]
        + [np.log(0.7) + 0.3 * rng.normal(size=n)
           for _ in range(N_EXTRA[typ])]
    )
    return obs, times, ids, par


def _jax_value_grad(fn, typ, obs, times, ids, par, sobs):
    def f(p, s):
        return fn(typ, p, obs, times, ids, s)

    vg = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))
    v, (gp, gs) = vg(jnp.asarray(par), sobs)
    return float(v), np.asarray(gp), float(gs)


def _port_value_grad(typ, obs, times, ids, par, sobs):
    p = torch.tensor(par, requires_grad=True)
    s = torch.tensor(sobs, dtype=torch.float64, requires_grad=True)
    v = tdf.diag_ssm_loglik_fused(typ, p, obs, times, ids, s)
    v.backward()
    return float(v.detach()), p.grad.numpy(), float(s.grad)


def _assert_match(got, ref):
    v, gp, gs = got
    rv, rgp, rgs = ref
    assert v == pytest.approx(rv, rel=1e-10)
    scale = np.max(np.abs(rgp))
    np.testing.assert_allclose(gp, rgp, rtol=1e-8, atol=1e-8 * scale)
    assert gs == pytest.approx(rgs, rel=1e-8)


# one compile of the interpret-mode kernels costs ~14 s on the CPU, so
# each type runs at one of the two widths
@pytest.mark.parametrize("typ,d", [("BM_SSM", 1), ("OU_SSM", 3)])
def test_matches_jax_pallas_interpret(monkeypatch, typ, d):
    monkeypatch.setenv("SMOOTHSDE_PALLAS_INTERPRET", "1")
    obs, times, ids, par = _data(typ, d, 90, 64 + d)
    _assert_match(_port_value_grad(typ, obs, times, ids, par, 0.3),
                  _jax_value_grad(jax_fused, typ, obs, times, ids, par, 0.3))


def _sequential(typ, p, obs, times, ids, s):
    return jax_soa(typ, p, obs, times, ids, s, scan="sequential")


@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
@pytest.mark.parametrize("d,n", [(1, 700), (2, 701), (3, 333)])
def test_matches_jax_sequential(typ, d, n):
    p = tcf.plan(d, n)
    assert p.NB > 1 and p.NB * p.L > n  # several blocks, padded lanes
    obs, times, ids, par = _data(typ, d, n, n + d)
    _assert_match(_port_value_grad(typ, obs, times, ids, par, 0.25),
                  _jax_value_grad(_sequential, typ, obs, times, ids, par,
                                  0.25))


@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
def test_sequential_oracle_matches_jax(typ):
    obs, times, ids, par = _data(typ, 2, 150, 9)
    p = torch.tensor(par, requires_grad=True)
    v = diag_ssm_loglik_sequential(typ, p, obs, times, ids, 0.2)
    v.backward()
    rv, rgp, _ = _jax_value_grad(_sequential, typ, obs, times, ids, par, 0.2)
    _assert_match((float(v.detach()), p.grad.numpy(), 0.0), (rv, rgp, 0.0))


def test_plain_core_equals_kernel_core_on_cpu():
    """On CPU tensors the kernel-backed core runs the plain versions, so
    the two autograd Functions agree exactly, and no launch is counted."""
    obs, times, ids, par = _data("OU_SSM", 2, 300, 6)
    data = tdf.prepare_diag_data("OU_SSM", obs, times, ids,
                                 dtype=torch.float64, device="cpu")
    tcf.reset_launches()
    out = []
    for core in (tdf.DiagFusedCore, tdf.DiagPlainCore):
        pt = torch.tensor(par, requires_grad=True)
        s = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
        sysd = tdf.diag_system("OU_SSM", pt, None, None, None, s, data=data)
        v = tdf.diag_fused_loglik(sysd, core)
        v.backward()
        out.append((v.detach(), pt.grad, s.grad))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert all(c == 0 for c in tcf.LAUNCHES.values())


def test_stack_padding_and_masks():
    """Padding past n holds t = 1 and zeros elsewhere (identity
    elements); the backward rows look one step ahead: tn = t[i+1] (1 at
    the end), te = reset[i+1] (1 at the end), tvn = no reset at i+1 nor
    at i (0 at the end); upd = valid * (1 - rst)."""
    d, n = 2, 131
    obs, times, ids, par = _data("BM_SSM", d, n, 8)
    ids = np.zeros(n, int)
    ids[40:], ids[41:], ids[97:] = 1, 2, 3
    sysd = tdf.diag_system("BM_SSM", torch.tensor(par), obs, times, ids, 0.3)
    p = tcf.plan(d, n)
    assert p.NB * p.L > n
    args = (sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef, p)
    fwd, bwd = tdf.forward_stack(*args), tdf.backward_stack(*args)
    reset = np.concatenate([[True], ids[1:] != ids[:-1]])
    prev = np.concatenate([[True], reset[:-1]])
    t = sysd.t.numpy()
    want = {
        0: np.append(t[1:], 1.0),
        3: np.append(reset[1:], True),
        4: np.append((~reset & ~prev)[1:], False),
        6: np.isfinite(obs[:, 0]) & ~reset,
        7: reset,
    }
    rows = tcf.unstack(bwd, p).numpy()
    for i, w in want.items():
        np.testing.assert_array_equal(rows[i], np.broadcast_to(w, (d, n)))
    for stack, pads in ((fwd, tdf._FWD_PAD), (bwd, tdf._BWD_PAD)):
        k = stack.shape[1]
        full = stack.reshape(p.L, k, d, p.NB).permute(1, 2, 3, 0)
        tail = full.reshape(k, d, -1)[:, :, n:]
        for i, v in enumerate(pads):
            assert torch.all(tail[i] == v)


def test_bm_centring_is_exact():
    """BM_SSM data are centred on a reference path (prepare_diag_data):
    on a strongly drifting record the value and gradient still match the
    uncentred JAX filter in f64, the finite observations the kernels see
    are small, and centred data are refused by an OU_SSM system."""
    obs, times, ids, par = _data("BM_SSM", 2, 400, 12)
    obs = obs + 50.0 * np.arange(400)[:, None]
    _assert_match(_port_value_grad("BM_SSM", obs, times, ids, par, 0.3),
                  _jax_value_grad(_sequential, "BM_SSM", obs, times, ids,
                                  par, 0.3))
    data = tdf.prepare_diag_data("BM_SSM", obs, times, ids,
                                 dtype=torch.float64, device="cpu")
    # finite observations become small (a NaN slot keeps 0 - g, exactly)
    yd = data.yd.numpy()[np.isfinite(obs.T)]
    assert np.max(np.abs(yd)) < 10.0 < np.nanmax(np.abs(obs))
    ou_par = np.column_stack([par, par[:, -1]])
    with pytest.raises(ValueError, match="OU_SSM"):
        tdf.diag_system("OU_SSM", torch.tensor(ou_par), None, None, None,
                        0.3, data=data)
