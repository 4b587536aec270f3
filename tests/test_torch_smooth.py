"""PyTorch port vs JAX package: the blocked associative scan, the RTS
smoother and the smoothed states.

- ops/scan_utils.py `blocked_associative_scan` with its plain phase 1
  (and "pallas", whose wrapper runs the same plain version on CPU
  tensors) against JAX `blocked_associative_scan` (values: its phase 2
  is an associative_scan, which XLA:CPU cannot differentiate reliably)
  for the filtering elements (Element2, `_combine2`) and the RTS
  smoothing elements (Smooth2, `_combine2_rev`, in reverse order: the
  JAX package's flip / scan / flip);
- the phase-1 plain version against JAX `pallas_phase1_scan` in Pallas
  interpret mode (SMOOTHSDE_PALLAS_INTERPRET=1, 1,024 lanes);
- `ctcrw_smoothed_states` for every scan against JAX
  `ctcrw_smoothed_states(scan="sequential")`.

f64, rtol 1e-10 of each output's scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops import kalman_smooth as jks
from smoothsde_tpu.ops import kalman_soa as jka
from smoothsde_tpu.ops import scan_utils as jsu
from smoothsde_tpu_torch.ops import ctcrw_fused as tcf
from smoothsde_tpu_torch.ops import kalman_smooth as tks
from smoothsde_tpu_torch.ops import kalman_soa as tka
from smoothsde_tpu_torch.ops import scan_utils as tsu


def _data(d, n, seed, n_tracks=2):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.2, 1.5, size=n))
    ids = np.sort(rng.integers(0, n_tracks, size=n))
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[rng.integers(1, n, size=max(2, n // 40))] = np.nan
    par = np.column_stack([
        0.1 * rng.normal(size=(n, d)),
        np.log(2.0) + 0.3 * rng.normal(size=n),
        np.log(0.8) + 0.3 * rng.normal(size=n),
    ])
    return obs, times, ids, par


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.broadcast_to(np.asarray(want),
                                                 np.shape(got))
    scale = max(np.max(np.abs(want)), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@functools.lru_cache(maxsize=None)
def _elements(d, n):
    """Filtering and smoothing elements of the same data in both
    packages: (port Element2, JAX Element2, port Smooth2, JAX Smooth2)."""
    obs, times, ids, par = _data(d, n, 10 * d + n)
    ts = tka._ctcrw_system(torch.tensor(par), obs, times, ids, 0.2)
    js = jka._ctcrw_system(jnp.asarray(par), obs, times, ids, 0.2,
                           dt=jka.precompute_dt(times, ids))
    # smoothing elements from the sequential filter of each package
    tf = tka._scan_elements(tka._combine2, tka._ID2, ts.elem, "sequential")
    jf = jka._scan_elements(jka._combine2, jka._ID2, js.elem, "sequential")
    te_t = torch.cat([ts.reset[1:], ts.reset.new_ones(1)])
    te_j = jnp.concatenate([js.reset[1:], jnp.ones((1,), bool)])
    tsm = _smooth_elems_port(ts, tf, te_t)
    jsm = _smooth_elems_jax(js, jf, te_j)
    return ts.elem, js.elem, tsm, jsm


def _smooth_elems_port(sys, f, te):
    """The RTS smoothing elements rts_smoother_soa scans (port)."""
    return tks.rts_elements(sys.Ft, sys.ct, sys.Qt, f.b, f.C, te)[0]


def _smooth_elems_jax(sys, f, te):
    """The RTS smoothing elements rts_smoother_soa scans (JAX), in time
    order."""
    seen = {}
    orig = jks._scan_elements

    def spy(combine, identity, elem, scan):
        seen["elem"] = jks._flip(elem)
        return orig(combine, identity, elem, scan)

    jks._scan_elements = spy
    try:
        jks.rts_smoother_soa(sys.Ft, sys.ct, sys.Qt, f.b, f.C,
                             jnp.broadcast_to(te, sys.yd.shape), "sequential")
    finally:
        jks._scan_elements = orig
    return seen["elem"]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@functools.lru_cache(maxsize=None)
def _jax_blocked(d, n, kind):
    """JAX blocked_associative_scan of the filtering ("filter") or the
    smoothing ("smooth", in reverse order) elements, leaves as NumPy."""
    _, jelem, _, jsm = _elements(d, n)
    if kind == "filter":
        out = jsu.blocked_associative_scan(jka._combine2, jka._ID2, jelem)
    else:
        out = jks._flip(jsu.blocked_associative_scan(
            jks._combine2_rev, jks._ID_S2, jks._flip(jsm)))
    return _leaves(out)


@pytest.mark.parametrize("phase1", ["plain", "pallas"])
@pytest.mark.parametrize("kind", ["filter", "smooth"])
@pytest.mark.parametrize("d,n", [(2, 700), (3, 333)])
def test_blocked_scan_matches_jax(d, n, kind, phase1):
    """The smoothing elements scan in reverse: the port walks the lanes
    backwards and takes the cross-lane suffix; JAX flips, scans, flips."""
    telem, _, tsm, _ = _elements(d, n)
    if kind == "filter":
        got = tsu.blocked_associative_scan(tka._combine2, tka._ID2, telem,
                                           phase1=phase1)
    else:
        got = tsu.blocked_associative_scan(tks._combine2_rev, tks._ID_S2,
                                           tsm, phase1=phase1, reverse=True)
    for g, w in zip(_leaves(got), _jax_blocked(d, n, kind)):
        _close(g, w)


@pytest.mark.parametrize("kind", ["filter", "smooth"])
def test_phase1_plain_matches_jax_pallas_interpret(monkeypatch, kind):
    """The plain phase-1 scan against the JAX Pallas kernel in interpret
    mode, on one (8, 1024) tile of real elements (L_CH = 8: the interpret
    mode's cost grows steeply with the unrolled chunk)."""
    monkeypatch.setenv("SMOOTHSDE_PALLAS_INTERPRET", "1")
    L, lanes = 8, 1024
    obs, times, ids, par = _data(1, L * lanes, 5)
    sys = tka._ctcrw_system(torch.tensor(par), obs, times, ids, 0.2)
    telem = sys.elem
    if kind == "smooth":  # smoothing elements of the filtered moments
        f = tka._scan_elements(tka._combine2, tka._ID2, sys.elem, "blocked")
        telem = _smooth_elems_port(sys, f, torch.cat(
            [sys.reset[1:], sys.reset.new_ones(1)]))
    k = tcf.ELEMS[kind]
    # lane b holds steps b*L .. b*L + L - 1, as in the blocked scan
    stack = torch.stack([x.expand(1, L * lanes).reshape(lanes, L).T
                         for x in k.pack(telem)], dim=1).contiguous()
    got = tsu.pallas_phase1_scan_plain(stack, kind)
    comps = [jnp.asarray(stack[:, c].reshape(L, lanes // 128, 128).numpy())
             for c in range(stack.shape[1])]
    if kind == "filter":
        combine, ident = jka._combine2, jka._ID2
        tiles = jka.Element2(*tcf._unpack_elem_full(comps))
    else:
        combine, ident = jks._combine2_rev, jks._ID_S2
        tiles = jks.Smooth2(*tcf._unpack_sm(comps))
    want = k.pack(jsu.pallas_phase1_scan(combine, ident, tiles, L, L_CH=L))
    for c in range(stack.shape[1]):
        _close(got[:, c].numpy(), np.asarray(want[c]).reshape(L, lanes))


@functools.lru_cache(maxsize=None)
def _jax_smoothed(d, n):
    obs, times, ids, par = _data(d, n, 7 * d + n, n_tracks=3)
    means, covs = jks.ctcrw_smoothed_states(jnp.asarray(par), obs, times, ids,
                                            0.25, scan="sequential")
    return (obs, times, ids, par), np.asarray(means), np.asarray(covs)


@pytest.mark.parametrize("scan", ["auto", "pallas", "blocked", "sequential",
                                  "associative"])
@pytest.mark.parametrize("d,n", [(1, 80), (2, 301)])
def test_smoothed_states_match_jax(d, n, scan):
    (obs, times, ids, par), jm, jc = _jax_smoothed(d, n)
    means, covs = tks.ctcrw_smoothed_states(torch.tensor(par), obs, times,
                                            ids, 0.25, scan=scan)
    assert means.shape == (d, n, 2) and covs.shape == (d, n, 2, 2)
    _close(means.numpy(), jm)
    _close(covs.numpy(), jc)


def test_unknown_scan_raises():
    telem, _, _, _ = _elements(1, 80)
    with pytest.raises(ValueError, match="scan"):
        tka._scan_elements(tka._combine2, tka._ID2, telem, "bogus")
