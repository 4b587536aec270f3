"""The CTCRW forward kernels' walk (csrc/ctcrw_filter.cu, K1a and K1b),
emulated on the CPU and held against the plain versions.

The kernels give each lane one thread, in CUDA blocks of `threads` lanes
(threads past the last lane exit), and walk its steps in order: the rows
of step l + 1 are read while step l computes (none past the last step),
the entering par is carried from step l - 1's rows and seeded from the
boundary rows `bd`, the llk term comes from the carry before the step and
the moments from the carry after it. `_emulate` does the same in PyTorch
and is held against `filter_totals_plain` / `filter_scan_plain` in f64 to
1e-12 at L in {1, 2, 3, 32}, with lanes not a multiple of the block, a
track start inside a lane, one on a lane's first step and one on a lane's
last (the next lane's `bd` carries it), NaN rows and irregular dt. Last,
the plain autograd core with the emulation in place of the plain K1
(`CtcrwPlainCore`) against the JAX package's sequential filter on the
same NumPy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops.kalman_soa import ctcrw_loglik_soa as jax_loglik
from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.ops.kalman_soa import (
    CtcrwPlainCore,
    _combine2,
    prepare_ctcrw_data,
)

NB = 37  # blocks per dim: lanes = 37 d, not a multiple of the CUDA block
P0_POS, P0_VEL = 1.0, 10.0


def _data(d, n, L, seed):
    """Four tracks: the second starts at step 1 of lane 5, the third on
    lane 9's first step, the fourth on lane 11's last (lane 12's boundary
    rows carry it); NaN rows, irregular dt, per-step varying
    parameters."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.05, 0.5, size=n))
    starts = [5 * L + 1, 9 * L, 12 * L - 1]
    ids = np.searchsorted(starts, np.arange(n), side="right")
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[rng.integers(1, n, size=max(2, n // 20))] = np.nan
    par = np.column_stack([
        0.1 * rng.normal(size=(n, d)),
        np.log(2.0) + 0.3 * rng.normal(size=n),
        np.log(0.8) + 0.3 * rng.normal(size=n),
    ])
    return obs, times, ids, par


def _inputs(d, L, monkeypatch):
    """(stack, bd, prefix, h) of the par-space forward at L steps per lane
    and NB blocks per dim; the prefix from the plain K1a and K2."""
    monkeypatch.setattr(cf, "STEPS_PER_LANE", L)
    n = NB * L - 1 if L > 1 else NB
    obs, times, ids, par = _data(d, n, L, seed=10 * d + L)
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device="cpu")
    p = cf.plan(d, n)
    assert (p.L, p.NB) == (L, NB)
    stack, bd = cf.par_stack_from_data(torch.tensor(par), data.yd,
                                       data.dtv, data.resetf, data.validf, p)
    h = torch.tensor([0.04], dtype=torch.float64)
    tot = cf.filter_totals_plain(stack, bd, h, P0_POS, P0_VEL)
    return stack, bd, cf.block_prefix_plain(tot, d, "filter", False), h


def _emulate(stack, bd, prefix, h, p0_pos, p0_vel, threads):
    """K1a's totals and K1b's (moments, llk) by the kernels' walk."""
    L, _, lanes = stack.shape
    hs = h[0]
    totals, moments, llks = [], [], []
    for b in range(-(-lanes // threads)):
        cols = slice(b * threads, min(lanes, (b + 1) * threads))
        st = stack[:, :, cols]
        pv = tuple(bd[:, cols].unbind(0))
        tot = cf._unpack_elem_full(cf._identity(cf._ID_VALS, pv[0]))
        c = cf._unpack_elem_full(prefix[:, cols].unbind(0))
        acc = torch.zeros_like(pv[0])
        mom = []
        nxt = st[0].unbind(0)
        for l in range(L):
            rows = nxt
            if l + 1 < L:  # in flight while step l computes
                nxt = st[l + 1].unbind(0)
            e, w, pv = cf._step_elem(rows, pv, hs, p0_pos, p0_vel)
            acc = acc + cf._pred_llk(c, w["f01"], w["c0"], w["q00"],
                                     rows[6], rows[7], hs)
            tot = _combine2(tot, e)
            c = _combine2(c, e)
            mom.append(torch.stack([c.b[0], c.b[1], c.C[0][0], c.C[0][1],
                                    c.C[1][1]]))
        totals.append(torch.stack(cf._pack_elem(tot)))
        moments.append(torch.stack(mom))
        llks.append(acc)
    return torch.cat(totals, -1), torch.cat(moments, -1), torch.cat(llks)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("L", [1, 2, 3, 32])
@pytest.mark.parametrize("threads", [32, 128])
def test_emulated_walk_matches_plain(threads, L, d, monkeypatch):
    """The walk (CUDA blocks of 32 or 128 lanes, 37 d lanes) against the
    plain K1a / K1b in f64, atol 1e-12 of the output's scale."""
    stack, bd, prefix, h = _inputs(d, L, monkeypatch)
    tot, mom, llk = _emulate(stack, bd, prefix, h, P0_POS, P0_VEL, threads)
    want_mom, want_llk = cf.filter_scan_plain(stack, bd, prefix, h, P0_POS,
                                              P0_VEL)
    want_tot = cf.filter_totals_plain(stack, bd, h, P0_POS, P0_VEL)
    for got, want in ((tot, want_tot), (mom, want_mom), (llk, want_llk)):
        assert bool(torch.isfinite(want).all())
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * scale)


def test_emulated_core_matches_jax_sequential(monkeypatch):
    """CtcrwPlainCore with the emulated K1a / K1b (128-lane blocks) in
    place of the plain ones against the JAX package's f64 sequential filter and
    jax.grad on the same NumPy inputs: value rtol 1e-10, gradient 1e-8 of
    its largest component."""
    d, L = 2, 32
    n = NB * L - 1
    obs, times, ids, par = _data(d, n, L, seed=3)

    def totals(stack, bd, h, p0_pos, p0_vel):
        ident = torch.stack(cf._identity(cf._ID_VALS, bd[0]))
        return _emulate(stack, bd, ident, h, p0_pos, p0_vel, 128)[0]

    def scan(stack, bd, prefix, h, p0_pos, p0_vel):
        return _emulate(stack, bd, prefix, h, p0_pos, p0_vel, 128)[1:]

    monkeypatch.setitem(cf.OPS, "plain", cf.OPS["plain"]._replace(
        filter_totals=totals, filter_scan=scan))
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device="cpu")
    p = torch.tensor(par, requires_grad=True)
    s = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    v = CtcrwPlainCore.apply(p, data.yd, s * s, data.dtv, data.resetf,
                             data.validf, P0_POS, P0_VEL)
    v.backward()

    def f(pj, sj):
        return jax_loglik(pj, obs, times, ids, sj, scan="sequential")

    rv, (rgp, rgs) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(par), 0.2)
    assert float(v.detach()) == pytest.approx(float(rv), rel=1e-10)
    rgp = np.asarray(rgp)
    np.testing.assert_allclose(p.grad.numpy(), rgp, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(rgp)))
    assert float(s.grad) == pytest.approx(float(rgs), rel=1e-8)
