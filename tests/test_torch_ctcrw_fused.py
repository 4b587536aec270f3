"""PyTorch port vs JAX package: CTCRW log-likelihood and its gradient.

The port's `ctcrw_loglik_soa(scan="fused", analytic_grad=True)` (the
fit's route: the autograd.Function over the fused par-space
forward/backward; on CPU tensors every kernel wrapper runs its plain
version) against JAX `ctcrw_loglik_soa(scan="sequential")` and
`jax.grad`, as tests/test_kalman.py checks the JAX fused path: multi-
track data, NaN rows, d in {1, 2, 3}, several blocks per dim (n up to
1,500), per-step varying parameters. Value rtol 1e-10, gradient rtol
1e-8 (relative to the largest component).

Also pins the layout pieces the kernels read: the lane-start boundary
rows, the masks derived from resets, and the validity rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops.kalman_soa import ctcrw_loglik_soa as jax_loglik
from smoothsde_tpu_torch.ops import ctcrw_fused as tcf
from smoothsde_tpu_torch.ops.kalman_soa import (
    CtcrwFusedCore,
    CtcrwPlainCore,
    ctcrw_loglik_sequential,
    ctcrw_loglik_soa,
    prepare_ctcrw_data,
)


def _data(d, n, seed, n_tracks=2, track_starts=None):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.2, 1.5, size=n))
    if track_starts is None:
        ids = np.sort(rng.integers(0, n_tracks, size=n))
    else:
        ids = np.zeros(n, int)
        for s in track_starts:
            ids[s:] += 1
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


def _jax_value_grad(obs, times, ids, par, sobs):
    def f(p, s):
        return jax_loglik(p, obs, times, ids, s, scan="sequential")

    # jit: one compile instead of op-by-op dispatch (~5x faster here)
    vg = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))
    v, (gp, gs) = vg(jnp.asarray(par), sobs)
    return float(v), np.asarray(gp), float(gs)


def _port_value_grad(obs, times, ids, par, sobs):
    p = torch.tensor(par, requires_grad=True)
    s = torch.tensor(sobs, dtype=torch.float64, requires_grad=True)
    v = ctcrw_loglik_soa(p, obs, times, ids, s, scan="fused",
                         analytic_grad=True)
    v.backward()
    return float(v.detach()), p.grad.numpy(), float(s.grad)


def _assert_match(got, ref):
    v, gp, gs = got
    rv, rgp, rgs = ref
    assert v == pytest.approx(rv, rel=1e-10)
    scale = np.max(np.abs(rgp))
    np.testing.assert_allclose(gp, rgp, rtol=1e-8, atol=1e-8 * scale)
    assert gs == pytest.approx(rgs, rel=1e-8)


@pytest.mark.parametrize("d,n,seed", [(1, 80, 0), (2, 300, 1), (2, 1500, 2),
                                      (3, 999, 3)])
def test_value_and_grad_match_jax(d, n, seed):
    obs, times, ids, par = _data(d, n, seed)
    p = tcf.plan(d, n)
    assert p.NB > 1 and p.L > 1  # several blocks per dim
    _assert_match(_port_value_grad(obs, times, ids, par, 0.2),
                  _jax_value_grad(obs, times, ids, par, 0.2))


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_track_start_at_lane_boundary(offset):
    """A track starting at, just before or just after a lane start: the
    boundary row `bd` must carry the previous lane's last par and rst."""
    d, n = 2, 400
    p = tcf.plan(d, n)
    start = 3 * p.L + offset
    obs, times, ids, par = _data(d, n, 20 + offset,
                                 track_starts=[start, 7 * p.L])
    _assert_match(_port_value_grad(obs, times, ids, par, 0.15),
                  _jax_value_grad(obs, times, ids, par, 0.15))


def test_sequential_plain_filter_matches_jax():
    obs, times, ids, par = _data(2, 120, 5)
    p = torch.tensor(par, requires_grad=True)
    v = ctcrw_loglik_sequential(p, obs, times, ids, 0.2)
    v.backward()
    _assert_match((float(v.detach()), p.grad.numpy(), 0.0),
                  _jax_value_grad(obs, times, ids, par, 0.2)[:2] + (0.0,))


def test_plain_core_equals_kernel_core_on_cpu():
    """On CPU tensors the kernel-backed core runs the plain versions, so
    the two autograd Functions give identical results, and no kernel
    launch is counted."""
    obs, times, ids, par = _data(2, 200, 6)
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device="cpu")
    tcf.reset_launches()
    out = []
    for core in (CtcrwFusedCore, CtcrwPlainCore):
        pt = torch.tensor(par, requires_grad=True)
        h = torch.tensor(0.04, dtype=torch.float64, requires_grad=True)
        v = core.apply(pt, data.yd, h, data.dtv, data.resetf, data.validf,
                       1.0, 10.0)
        v.backward()
        out.append((v.detach(), pt.grad, h.grad))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert all(c == 0 for c in tcf.LAUNCHES.values())


def test_boundary_rows_and_masks():
    """bd holds the previous lane's last slot (lane 0: rst = 1); te and
    tvn look one step ahead; upd = valid * (1 - rst)."""
    d, n = 2, 130
    obs, times, ids, par = _data(d, n, 8, track_starts=[40, 41, 97])
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device="cpu")
    p = tcf.plan(d, n)
    stack, bd = tcf.par_stack_from_data(torch.tensor(par), data.yd,
                                        data.dtv, data.resetf, data.validf, p)
    rows = tcf.unstack(stack, p).numpy()  # (10, d, n)
    reset = np.concatenate([[True], ids[1:] != ids[:-1]])
    prev = np.concatenate([[True], reset[:-1]])
    te = np.concatenate([reset[1:], [True]])
    tv = ~reset & ~prev
    tvn = np.concatenate([tv[1:], [False]])
    upd = np.isfinite(obs[:, 0]) & ~reset
    for i, want in ((4, te), (5, tvn), (7, upd), (8, reset)):
        np.testing.assert_array_equal(rows[i], np.broadcast_to(want, (d, n)))
    np.testing.assert_array_equal(rows[9], 1.0)
    # padding slots (past n) are all zero, so they are identity elements
    pad = stack.reshape(p.L, 10, d, p.NB).permute(1, 2, 3, 0)
    pad = pad.reshape(10, d, -1)[:, :, n:]
    assert pad.numel() == 0 or torch.count_nonzero(pad) == 0
    bdv = bd.reshape(5, d, p.NB).numpy()
    for b in range(p.NB):
        j = b * p.L - 1
        if b == 0:
            assert np.all(bdv[4, :, 0] == 1.0)
            continue
        np.testing.assert_array_equal(bdv[0, :, b], par[j, d])
        np.testing.assert_array_equal(bdv[1, :, b], par[j, d + 1])
        np.testing.assert_array_equal(bdv[2, :, b], data.dtv[j].item())
        np.testing.assert_array_equal(bdv[3, :, b], par[j, :d])
        np.testing.assert_array_equal(bdv[4, :, b], float(reset[j]))


def test_wrapper_rejects_mixed_inputs():
    x = torch.zeros((3, 10, 4), dtype=torch.float64)
    bd = torch.zeros((5, 4), dtype=torch.float32)
    h = torch.ones(1, dtype=torch.float64)
    with pytest.raises(ValueError):
        tcf.filter_totals(x, bd, h, 1.0, 10.0)
    with pytest.raises(TypeError):
        tcf.block_prefix(torch.zeros((14, 4), dtype=torch.int64), 2,
                         "filter", False)

