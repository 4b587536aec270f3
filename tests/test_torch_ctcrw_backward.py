"""The CTCRW backward kernels' decomposition (csrc/ctcrw_backward.cu, K3a
and K3b), emulated on the CPU and held against the plain versions.

The kernels walk each block of `TILE` lanes (the last one zero-filled past
the lanes) from its last step to its first in chunks of S steps, one
thread per (step, lane) item of a chunk: the items' smoothing elements
first, then one chain per lane composes them into its carry, staging the
smoothed moments after each step; then each item's score from the staged
moments at l + 1 and l, its h term staged and summed by the chain in step
order. `_emulate` does the same in PyTorch, with S a parameter (the
kernels' is 2), and is held against `smooth_totals_plain` /
`score_scan_plain` in f64 to 1e-12 at L below, at and across the chunk,
with lanes not a multiple of the tile, two tracks whose start and end
fall inside one chunk, NaN rows and irregular dt. Last, the plain
autograd core these kernels sit in (`CtcrwPlainCore`) against the JAX
package's sequential filter on the same NumPy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops.kalman_soa import ctcrw_loglik_soa as jax_loglik
from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.ops.kalman_smooth import _combine2_rev
from smoothsde_tpu_torch.ops.kalman_soa import (
    CtcrwPlainCore,
    prepare_ctcrw_data,
)

TILE = 64  # lanes per CUDA block (kK3Tile)
NB = 37  # blocks per dim: lanes = 37 d, not a multiple of TILE


def _data(d, n, L, seed):
    """Two tracks (the second starts at step L - 1 of lane 5, so its start
    and the first track's end share the lane's first chunk), NaN rows,
    irregular dt, per-step varying parameters."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.05, 0.5, size=n))
    ids = (np.arange(n) >= 5 * L + max(L - 1, 0)).astype(int)
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[rng.integers(1, n, size=max(2, n // 20))] = np.nan
    par = np.column_stack([
        0.1 * rng.normal(size=(n, d)),
        np.log(2.0) + 0.3 * rng.normal(size=n),
        np.log(0.8) + 0.3 * rng.normal(size=n),
    ])
    return obs, times, ids, par


def _inputs(d, L, monkeypatch):
    """(stack, moments, suffix, h) of the par-space backward at L steps
    per lane and NB blocks per dim, from the plain forward."""
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
    tot = cf.filter_totals_plain(stack, bd, h, 1.0, 10.0)
    pre = cf.block_prefix_plain(tot, d, "filter", False)
    mom, _ = cf.filter_scan_plain(stack, bd, pre, h, 1.0, 10.0)
    suffix = cf.block_prefix_plain(cf.smooth_totals_plain(stack, mom), d,
                                   "smooth", True)
    return stack, mom, suffix, h


def _pad_lanes(x, lanes):
    """Zero-fill the last dim up to `lanes`, as the kernels' copies do."""
    return torch.nn.functional.pad(x, (0, lanes - x.shape[-1]))


def _emulate(stack, moments, suffix, h, p0_pos, S):
    """K3a's totals and K3b's (cot, hbar) by the kernels' decomposition."""
    L, _, lanes = stack.shape
    ntile = -(-lanes // TILE)
    totals, cots, hbars = [], [], []
    for b in range(ntile):
        cols = slice(b * TILE, (b + 1) * TILE)
        st = _pad_lanes(stack[:, :, cols], TILE)
        mo = _pad_lanes(moments[:, :, cols], TILE)
        zero = torch.zeros_like(st[0, 0])
        tot = cf._unpack_sm(cf._identity(cf._ID_SM, zero))  # K3a's carry
        acc = cf._unpack_sm(_pad_lanes(suffix[:, cols], TILE).unbind(0))
        ha = zero
        cot = torch.zeros((L, 4, TILE), dtype=st.dtype)
        for k in range(-(-L // S)):
            items = [L - 1 - k * S - j for j in range(S)]  # l of item j
            rows = [st[l] if l >= 0 else torch.zeros_like(st[0])
                    for l in items]
            moms = [mo[l] if l >= 0 else torch.zeros_like(mo[0])
                    for l in items]
            # element phase: every item, the zero-filled ones too
            el = [cf._par_smooth_elem(*r[:5], r[8], m.unbind(0))
                  for r, m in zip(rows, moms)]
            # chain phase: the chunk's real items in walk order
            real = [j for j, l in enumerate(items) if l >= 0]
            staged = [acc]  # slot 0: smoothed after the chunk
            for j in real:
                tot = _combine2_rev(tot, el[j][1])
                acc = _combine2_rev(acc, el[j][1])
                staged.append(acc)
            # score phase: item j reads slots j (at l + 1) and j + 1 (at l)
            hterm = []
            for j in real:
                w, _, G = el[j]
                TVn, y, U, R = rows[j][5:9]
                yb, h_j = cf._obs_score(y, staged[j + 1], U, R, h[0],
                                        p0_pos)
                cot[items[j]] = cf._step_cot(w, TVn, staged[j],
                                             staged[j + 1], G, yb)
                hterm.append(h_j)
            for h_j in hterm:  # the chain adds them in step order
                ha = ha + h_j
        n_real = min(TILE, lanes - b * TILE)
        totals.append(torch.stack(cf._pack_sm(tot))[:, :n_real])
        cots.append(cot[..., :n_real])
        hbars.append(ha[:n_real])
    return torch.cat(totals, -1), torch.cat(cots, -1), torch.cat(hbars)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("S,L", [(2, 1), (2, 2), (2, 3), (2, 32), (4, 1),
                                 (4, 3), (4, 4), (4, 5), (4, 32)])
def test_emulated_decomposition_matches_plain(S, L, d, monkeypatch):
    """The chunked walk (S steps a chunk, 64-lane tiles, 37 d lanes)
    against the plain K3a / K3b in f64, atol 1e-12 of the output's scale;
    L in {1, S - 1, S, S + 1, 32}."""
    stack, mom, suffix, h = _inputs(d, L, monkeypatch)
    tot, cot, hbar = _emulate(stack, mom, suffix, h, 1.0, S)
    want_cot, want_hbar = cf.score_scan_plain(stack, mom, suffix, h, 1.0)
    for got, want in ((tot, cf.smooth_totals_plain(stack, mom)),
                      (cot, want_cot), (hbar, want_hbar)):
        assert bool(torch.isfinite(want).all())
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * scale)


def test_plain_core_matches_jax_sequential():
    """CtcrwPlainCore (the plain versions of every par-space kernel behind
    the autograd.Function) against the JAX package's f64 sequential filter
    and jax.grad on the same NumPy inputs: value rtol 1e-10, gradient 1e-8
    of its largest component."""
    d, L = 2, 32
    n = NB * L - 1
    obs, times, ids, par = _data(d, n, L, seed=3)
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device="cpu")
    p = torch.tensor(par, requires_grad=True)
    s = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    v = CtcrwPlainCore.apply(p, data.yd, s * s, data.dtv, data.resetf,
                             data.validf, 1.0, 10.0)
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
