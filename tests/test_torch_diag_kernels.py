"""The scalar-state kernels D1a, D1b, D3a and D3b (csrc/diag_filter.cu,
csrc/diag_backward.cu) as they run on the card, emulated on the CPU and
held against the plain versions.

D1a, D1b and D3a cut each lane's L steps into S segments of consecutive
steps, one thread each, ceil(L / S) steps a segment, the last ones short
or empty (S = kD1Segs for D1a and, in f32, D1b; kD3aSegs for D3a); a
CUDA block holds kD1Lanes (kD3aLanes) lanes. In f64 D1b walks each lane
on one thread (S = 1, the plain version's order: the emulation at S = 1).
Within a segment a thread walks the
plain version's recurrence (its next step's loads run ahead, which
changes no value), so each emulation runs the plain version over each
segment:
- D1a composes each segment's filtering total from the identity; the
  lane's first thread combines the S totals in time order (earlier on
  the left).
- D1b starts segment s from the lane's exclusive prefix composed, in
  time order, with the totals of segments 0 .. s - 1 that D1a leaves,
  and rescans the segment; the lane's first thread sums the segments'
  llk partials in segment order.
- D3a walks each segment from its last step to its first from the
  identity; the lane's first thread composes the totals the last segment
  first, each earlier one applied outside (_comb1_rev).
D3b walks each lane on one thread, in the plain version's order step for
step, with the next step's rows in flight: the plain version is its
emulation.

Held against the plain versions in f64 to 1e-12 of the output's scale at
L in {1, 2, 3, 5, 32, 64} and S in {1, 2, 4, 8}, with lanes not a
multiple of the block, a track start inside a segment, one on a
segment's first step and one on a lane's last step, NaN rows and
irregular dt, for OU_SSM and BM_SSM. Last, the plain autograd core with
the emulated kernels (at the shipped f32 geometry) in place of the plain
ones against the JAX package's sequential filter.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops.kalman_soa import diag_ssm_loglik_soa as jax_soa
from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.ops import diag_fused as df
from smoothsde_tpu_torch.ops.kalman_smooth import _ID1_SM, _comb1_rev
from smoothsde_tpu_torch.ops.kalman_soa import _ID1, _comb1

CSRC = Path(df.__file__).resolve().parents[1] / "csrc"
NB = 37  # blocks per dim: lanes = 37 d, not a multiple of a CUDA block
N_EXTRA = {"BM_SSM": 1, "OU_SSM": 2}


def _constant(name, source="diag_filter.cu"):
    """The value of `constexpr int name = ...;` in csrc/<source>."""
    text = (CSRC / source).read_text()
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


def _blocks(lanes, lanes_per_block):
    """The lane slices of the kernel's CUDA blocks."""
    return [slice(b * lanes_per_block, (b + 1) * lanes_per_block)
            for b in range(-(-lanes // lanes_per_block))]


def emulate_filter_scan(stack, prefix, h, p0, segs, lanes_per_block=32):
    """D1b's moments (L, 2, lanes) and llk (lanes,) by the kernel's CUDA
    blocks and segments, each seeded from the prefix and D1a's totals of
    the lane's earlier segments."""
    L, _, lanes = stack.shape
    moments, llk = [], []
    for sl in _blocks(lanes, lanes_per_block):
        st = stack[:, :, sl]
        seed = tuple(prefix[:, sl].unbind(0))
        parts, acc = [], None
        for lo, hi in _segments(L, segs):
            if lo == hi:  # empty: no steps, a zero llk partial
                continue
            m, a = df.diag_filter_scan_plain(st[lo:hi], torch.stack(seed), h,
                                             p0)
            parts.append(m)
            acc = a if acc is None else acc + a
            seed = _comb1(seed, tuple(df.diag_filter_totals_plain(
                st[lo:hi], h, p0).unbind(0)))
        moments.append(torch.cat(parts, 0))
        llk.append(acc)
    return torch.cat(moments, -1), torch.cat(llk, -1)


def emulate_smooth_totals(stack, moments, segs, lanes_per_block=32):
    """D3a's totals (3, lanes) by the kernel's CUDA blocks and segments."""
    L, _, lanes = stack.shape
    out = []
    for sl in _blocks(lanes, lanes_per_block):
        st, mo = stack[:, :, sl], moments[:, :, sl]
        parts = []
        for lo, hi in _segments(L, segs):
            if lo == hi:  # empty: the identity
                parts.append(df._identity(_ID1_SM, st[0, 0]))
            else:
                parts.append(tuple(df.diag_smooth_totals_plain(
                    st[lo:hi], mo[lo:hi]).unbind(0)))
        tot = parts[-1]
        for c in reversed(parts[:-1]):
            tot = _comb1_rev(tot, c)
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


def _chain(typ, d, L, segs, seed_base, monkeypatch):
    """The plain chain's inputs at L steps per lane and NB blocks per dim:
    (forward stack, h, prefix, backward stack, moments)."""
    monkeypatch.setattr(cf, "STEPS_PER_LANE", L)
    n = NB * L - 1 if L > 1 else NB
    obs, times, ids, par = _data(typ, d, n, L, -(-L // segs),
                                 seed_base + 10 * L + segs)
    p = cf.plan(d, n)
    assert (p.L, p.NB) == (L, NB)
    sysd = df.diag_system(typ, torch.tensor(par), obs, times, ids, 0.3)
    rows = (sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef, p)
    fst, bst = df.forward_stack(*rows), df.backward_stack(*rows)
    h = sysd.h.reshape(1)
    pre = cf.block_prefix_plain(df.diag_filter_totals_plain(fst, h, df.P0),
                                d, "diag_filter", False)
    mom, _ = df.diag_filter_scan_plain(fst, pre, h, df.P0)
    return fst, h, pre, bst, mom


def _close(got, want):
    """Equal to 1e-12 of want's scale, want finite."""
    assert bool(torch.isfinite(want).all())
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("typ,d", [("OU_SSM", 2), ("BM_SSM", 1)])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 32, 64])
@pytest.mark.parametrize("segs", [1, 2, 4, 8])
def test_emulated_scan_segments_match_plain(segs, L, typ, d, monkeypatch):
    """D1b's moments and llk by its seeded segments (from D1a's segment
    totals) against the plain one-thread rescan in f64, per lane and
    summed, atol 1e-12 of the output's scale."""
    fst, h, pre, _, _ = _chain(typ, d, L, segs, 3, monkeypatch)
    want_mom, want_llk = df.diag_filter_scan_plain(fst, pre, h, df.P0)
    mom, llk = emulate_filter_scan(fst, pre, h, df.P0, segs)
    _close(mom, want_mom)
    _close(llk, want_llk)
    _close(llk.sum(), want_llk.sum())


@pytest.mark.parametrize("typ,d", [("OU_SSM", 2), ("BM_SSM", 1)])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 32, 64])
@pytest.mark.parametrize("segs", [1, 2, 4, 8])
def test_emulated_smooth_segments_match_plain(segs, L, typ, d, monkeypatch):
    """D3a's totals by its reverse-time segments against the plain
    one-thread walk in f64, atol 1e-12 of the output's scale."""
    _, _, _, bst, mom = _chain(typ, d, L, segs, 7, monkeypatch)
    _close(emulate_smooth_totals(bst, mom, segs),
           df.diag_smooth_totals_plain(bst, mom))


@pytest.mark.parametrize("typ,d", [("OU_SSM", 2), ("BM_SSM", 1)])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 32, 64])
@pytest.mark.parametrize("segs", [1, 2, 4, 8])
def test_emulated_segments_match_plain(segs, L, typ, d, monkeypatch):
    """D1a's totals by its segments against the plain one-thread walk in
    f64 at L steps per lane and NB blocks per dim, atol 1e-12 of the
    output's scale."""
    fst, h, _, _, _ = _chain(typ, d, L, segs, 0, monkeypatch)
    _close(emulate_filter_totals(fst, h, df.P0, segs),
           df.diag_filter_totals_plain(fst, h, df.P0))


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
    """The segment counts of D1a / D1b and of D3a are ones the emulations
    cover, and each CUDA block holds whole warps of lanes."""
    assert _constant("kD1Segs") in (1, 2, 4, 8)
    assert _constant("kD1Lanes") % 32 == 0
    assert _constant("kD3aSegs", "diag_backward.cu") in (1, 2, 4, 8)
    assert _constant("kD3aLanes", "diag_backward.cu") % 32 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_wrappers_take_an_empty_segment_scratch(dtype):
    """For a CPU stack the segment scratch is empty (no kernels are
    asked for its size) and D1a's and D1b's wrappers return their plain
    versions' values, the scratch left as it is."""
    g = torch.Generator().manual_seed(0)
    L, lanes = 5, 7
    fst = torch.rand((L, 6, lanes), generator=g, dtype=dtype) + 0.5
    fst[:, 4:] = (fst[:, 4:] > 1.0).to(dtype)  # 0/1 reset / update masks
    h = torch.full((1,), 0.3, dtype=dtype)
    seg = df.segment_scratch(fst)
    assert tuple(seg.shape) == (0, 5, lanes)
    tot = df.diag_filter_totals(fst, h, df.P0, seg)
    torch.testing.assert_close(tot, df.diag_filter_totals_plain(fst, h, df.P0),
                               rtol=0, atol=0)
    pre = torch.rand((5, lanes), generator=g, dtype=dtype)
    got = df.diag_filter_scan(fst, pre, seg, h, df.P0)
    want = df.diag_filter_scan_plain(fst, pre, h, df.P0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _core_matches_jax(typ, d, n, seed, monkeypatch, **emulated):
    """DiagPlainCore with the plain kernels of `emulated` replaced against
    the JAX package's f64 sequential filter and jax.grad on the same NumPy
    inputs: value rtol 1e-10, gradient 1e-8 of its largest component."""
    obs, times, ids, par = _data(typ, d, n, cf.STEPS_PER_LANE, 8, seed=seed)
    monkeypatch.setitem(df.OPS, "plain", df.OPS["plain"]._replace(**emulated))
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


@pytest.mark.parametrize("typ,d,n", [("OU_SSM", 2, 701), ("BM_SSM", 1, 700)])
def test_emulated_core_matches_jax_sequential(typ, d, n, monkeypatch):
    """The emulated D1a at the shipped segment count and lanes per block
    in place of the plain one (_core_matches_jax)."""
    segs, lanes = _constant("kD1Segs"), _constant("kD1Lanes")
    _core_matches_jax(
        typ, d, n, 3, monkeypatch,
        filter_totals=lambda stack, h, p0, seg: emulate_filter_totals(
            stack, h, p0, segs, lanes))


@pytest.mark.parametrize("typ,d,n", [("OU_SSM", 2, 701), ("BM_SSM", 1, 700)])
def test_emulated_segmented_core_matches_jax_sequential(typ, d, n,
                                                        monkeypatch):
    """The emulated D1a, D1b and D3a at the shipped f32 segment counts and
    lanes per block in place of the plain ones (_core_matches_jax)."""
    s1, l1 = _constant("kD1Segs"), _constant("kD1Lanes")
    s3 = _constant("kD3aSegs", "diag_backward.cu")
    l3 = _constant("kD3aLanes", "diag_backward.cu")
    _core_matches_jax(
        typ, d, n, 5, monkeypatch,
        filter_totals=lambda stack, h, p0, seg: emulate_filter_totals(
            stack, h, p0, s1, l1),
        filter_scan=lambda stack, prefix, seg, h, p0: emulate_filter_scan(
            stack, prefix, h, p0, s1, l1),
        smooth_totals=lambda stack, mom: emulate_smooth_totals(
            stack, mom, s3, l3))
