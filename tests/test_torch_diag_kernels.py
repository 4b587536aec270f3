"""The scalar-state kernels D1a and D3b (csrc/diag_filter.cu,
csrc/diag_backward.cu) as they run on the card, emulated on the CPU and
held against the plain versions.

D1a cuts each lane's L steps into S segments of consecutive steps, one
thread each (S = kD1Segs), ceil(L / S) steps a segment, the last ones
short or empty; a CUDA block holds kD1Lanes lanes. Each thread composes
its segment's filtering total from the identity, and the lane's first
thread combines the S totals in time order (earlier on the left). Within
a segment the thread walks the plain version's recurrence (its next
step's loads run ahead, which changes no value), so the emulation runs
the plain version over each segment and combines the totals as the
kernel does. D3b walks each lane on one thread, in the plain version's
order step for step, with the next step's rows in flight: the plain
version is its emulation.

Held against `diag_filter_totals_plain` in f64 to 1e-12 of the output's
scale at L in {1, 2, 3, 5, 32, 64} and S in {1, 2, 4, 8}, with lanes not
a multiple of the block, a track start inside a segment, one on a
segment's first step and one on a lane's last step, NaN rows and
irregular dt, for OU_SSM and BM_SSM. Last, the plain autograd core with
the emulated D1a (at the shipped S) in place of the plain one against
the JAX package's sequential filter.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothsde_tpu.ops.kalman_soa import diag_ssm_loglik_soa as jax_soa
from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.ops import diag_fused as df
from smoothsde_tpu_torch.ops.kalman_soa import _ID1, _comb1

CSRC = Path(df.__file__).resolve().parents[1] / "csrc"
NB = 37  # blocks per dim: lanes = 37 d, not a multiple of a CUDA block
N_EXTRA = {"BM_SSM": 1, "OU_SSM": 2}


def _constant(name):
    """The value of `constexpr int name = ...;` in csrc/diag_filter.cu."""
    text = (CSRC / "diag_filter.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _segments(L, S):
    """[lo, hi) of each of the S segments (diag_filter.cu `segment_of`)."""
    n = -(-L // S)
    return [(min(L, s * n), min(L, min(L, s * n) + n)) for s in range(S)]


def emulate_filter_totals(stack, h, p0, segs, lanes_per_block=32):
    """D1a's totals (5, lanes) by the kernel's CUDA blocks and segments."""
    L, _, lanes = stack.shape
    out = []
    for b in range(-(-lanes // lanes_per_block)):
        st = stack[:, :, b * lanes_per_block:(b + 1) * lanes_per_block]
        parts = []
        for lo, hi in _segments(L, segs):
            if lo == hi:  # empty: the identity
                parts.append(df._identity(_ID1, st[0, 0]))
            else:
                parts.append(tuple(df.diag_filter_totals_plain(
                    st[lo:hi], h, p0).unbind(0)))
        tot = parts[0]
        for c in parts[1:]:
            tot = _comb1(tot, c)
        out.append(torch.stack(tot))
    return torch.cat(out, -1)


def _data(typ, d, n, L, seg, seed):
    """Four tracks: the second starts inside lane 5's first segment (step
    1, when segments hold 2 steps or more), the third on lane 9's second
    segment's first step (or the lane's first, for one segment), the
    fourth on lane 11's last step; NaN rows, irregular dt, per-step
    varying parameters."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.05, 0.5, size=n))
    starts = sorted({5 * L + min(1, L - 1), 9 * L + (seg if seg < L else 0),
                     12 * L - 1})
    ids = np.searchsorted(starts, np.arange(n), side="right")
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[rng.integers(1, n, size=max(2, n // 20))] = np.nan
    par = np.column_stack(
        [0.1 * rng.normal(size=(n, d))]
        + [np.log(0.7) + 0.3 * rng.normal(size=n)
           for _ in range(N_EXTRA[typ])])
    return obs, times, ids, par


@pytest.mark.parametrize("typ,d", [("OU_SSM", 2), ("BM_SSM", 1)])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 32, 64])
@pytest.mark.parametrize("segs", [1, 2, 4, 8])
def test_emulated_segments_match_plain(segs, L, typ, d, monkeypatch):
    """D1a's totals by its segments against the plain one-thread walk in
    f64 at L steps per lane and NB blocks per dim, atol 1e-12 of the
    output's scale."""
    monkeypatch.setattr(cf, "STEPS_PER_LANE", L)
    n = NB * L - 1 if L > 1 else NB
    obs, times, ids, par = _data(typ, d, n, L, -(-L // segs), 10 * L + segs)
    p = cf.plan(d, n)
    assert (p.L, p.NB) == (L, NB)
    sysd = df.diag_system(typ, torch.tensor(par), obs, times, ids, 0.3)
    fst = df.forward_stack(sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf,
                           sysd.updatef, p)
    h = sysd.h.reshape(1)
    want = df.diag_filter_totals_plain(fst, h, df.P0)
    assert bool(torch.isfinite(want).all())
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(emulate_filter_totals(fst, h, df.P0, segs),
                               want, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("L,S,want", [
    (32, 4, [(0, 8), (8, 16), (16, 24), (24, 32)]),
    (5, 4, [(0, 2), (2, 4), (4, 5), (5, 5)]),
    (3, 4, [(0, 1), (1, 2), (2, 3), (3, 3)]),
    (1, 8, [(0, 1)] + [(1, 1)] * 7),
    (64, 4, [(0, 16), (16, 32), (32, 48), (48, 64)]),
    (32, 1, [(0, 32)])])
def test_segment_rule(L, S, want):
    """ceil(L / S) steps a segment, in order, the last ones short or
    empty."""
    assert _segments(L, S) == want


def test_shipped_geometry():
    """D1a's segment count is one the emulation covers, and its CUDA
    block holds whole warps of lanes."""
    assert _constant("kD1Segs") in (1, 2, 4, 8)
    assert _constant("kD1Lanes") % 32 == 0


@pytest.mark.parametrize("typ,d,n", [("OU_SSM", 2, 701), ("BM_SSM", 1, 700)])
def test_emulated_core_matches_jax_sequential(typ, d, n, monkeypatch):
    """DiagPlainCore with the emulated D1a at the shipped segment count
    and lanes per block in place of the plain one against the JAX
    package's f64 sequential filter and jax.grad on the same NumPy inputs:
    value rtol 1e-10, gradient 1e-8 of its largest component."""
    obs, times, ids, par = _data(typ, d, n, cf.STEPS_PER_LANE, 8, seed=3)
    segs, lanes = _constant("kD1Segs"), _constant("kD1Lanes")

    def totals(stack, h, p0):
        return emulate_filter_totals(stack, h, p0, segs, lanes)

    monkeypatch.setitem(df.OPS, "plain",
                        df.OPS["plain"]._replace(filter_totals=totals))
    p = torch.tensor(par, requires_grad=True)
    s = torch.tensor(0.25, dtype=torch.float64, requires_grad=True)
    v = df.diag_fused_loglik(
        df.diag_system(typ, p, obs, times, ids, s), df.DiagPlainCore)
    v.backward()

    def f(pj, sj):
        return jax_soa(typ, pj, obs, times, ids, sj, scan="sequential")

    rv, (rgp, rgs) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(par), 0.25)
    assert float(v.detach()) == pytest.approx(float(rv), rel=1e-10)
    rgp = np.asarray(rgp)
    np.testing.assert_allclose(p.grad.numpy(), rgp, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(rgp)))
    assert float(s.grad) == pytest.approx(float(rgs), rel=1e-8)
