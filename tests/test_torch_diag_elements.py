"""PyTorch port vs JAX package: the scalar-state (BM_SSM / OU_SSM)
element algebra and per-step system.

`_elem1`, `_comb1`, `_comb1_rev` against the JAX functions of
smoothsde_tpu/ops/diag_fused.py on the same random f64 inputs (1e-13
relative), the identities and associativity the cross-block prefix
relies on, and `diag_system` against the JAX `diag_system` for both
types (1e-12 relative: the port's OU noise factor is the stable
em1(u)(1 + decay), the JAX function's 1 - decay**2, equal to roundoff
in f64 at these intervals; the port's BM_SSM system is centred on its
observations and is compared after adding the centring path back). `diag_elements` and `diag_llk_from_filtered`
are held against theirs through the same system.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops import diag_fused as jdf
from smoothsde_tpu_torch.ops import diag_fused as tdf
from smoothsde_tpu_torch.ops.kalman_smooth import _ID1_SM, _comb1_rev
from smoothsde_tpu_torch.ops.kalman_soa import _ID1, _comb1

TOL = 1e-13
M = 64  # lanes


def _close(got, ref, tol=TOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _random_elem(rng):
    """A composed-like filtering element: |A| < 1, C, J > 0."""
    return [rng.uniform(-0.9, 0.9, M), rng.normal(size=M),
            rng.uniform(0.01, 2.0, M), rng.normal(size=M),
            rng.uniform(0.0, 3.0, M)]


def _random_smooth(rng):
    return [rng.uniform(-0.9, 0.9, M), rng.normal(size=M),
            rng.uniform(0.01, 2.0, M)]


def _both(vals):
    return (tuple(jnp.asarray(v) for v in vals),
            tuple(torch.tensor(v) for v in vals))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_comb1_matches_jax(seed):
    rng = np.random.default_rng(seed)
    (j1, t1), (j2, t2) = _both(_random_elem(rng)), _both(_random_elem(rng))
    for g, r in zip(_comb1(t1, t2), jdf._comb1(j1, j2)):
        _close(g, r)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_comb1_rev_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    (j1, t1), (j2, t2) = _both(_random_smooth(rng)), _both(_random_smooth(rng))
    for g, r in zip(_comb1_rev(t1, t2), jdf._comb1_rev(j1, j2)):
        _close(g, r)


def test_identities_match_jax():
    assert tuple(_ID1) == tuple(jdf._ID1)
    assert tuple(_ID1_SM) == tuple(jdf._ID1_SM)


@pytest.mark.parametrize("combine,make,ident", [
    (_comb1, _random_elem, _ID1),
    (_comb1_rev, _random_smooth, _ID1_SM),
])
def test_identity_and_associativity(combine, make, ident):
    rng = np.random.default_rng(5)
    a, b, c = (tuple(torch.tensor(v) for v in make(rng)) for _ in range(3))
    e = tuple(torch.full((M,), v, dtype=torch.float64) for v in ident)
    for x, y in zip(combine(e, a), a):
        _close(x, y.numpy())
    for x, y in zip(combine(a, e), a):
        _close(x, y.numpy())
    left = combine(combine(a, b), c)
    right = combine(a, combine(b, c))
    for x, y in zip(left, right):
        _close(x, y.numpy(), tol=1e-12)
    # not commutative: the orientation matters
    assert any(not torch.allclose(x, y)
               for x, y in zip(combine(a, b), combine(b, a)))


def test_elem1_matches_jax():
    """The port's by-value `_elem1` against the JAX tile form, over
    reset / update / propagate-only steps."""
    rng = np.random.default_rng(3)
    rows = {
        "t": rng.uniform(0.3, 1.0, M), "q": rng.uniform(0.0, 2.0, M),
        "c": rng.normal(size=M), "y": rng.normal(size=M),
        "rst": (rng.uniform(size=M) < 0.2).astype(float),
        "upd": (rng.uniform(size=M) < 0.7).astype(float),
    }
    tiles = jdf._Tiles1(*(jnp.asarray(rows[k])[None] for k in
                          ("t", "q", "c", "y", "rst", "upd")))
    ref = jdf._elem1(tiles, 0.04, 10.0, 0)
    got = tdf._elem1(*(torch.tensor(rows[k]) for k in
                       ("t", "q", "c", "y", "rst", "upd")), 0.04, 10.0)
    for g, r in zip(got, ref):
        _close(g, r)


def _data(d, n, seed):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.2, 0.8, size=n))
    ids = np.sort(rng.integers(0, 3, size=n))
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[rng.integers(1, n, size=4)] = np.nan
    par = np.column_stack([
        0.1 * rng.normal(size=(n, d)),
        np.log(1.5) + 0.3 * rng.normal(size=n),
        np.log(0.6) + 0.3 * rng.normal(size=n),
    ])
    return obs, times, ids, par


@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
@pytest.mark.parametrize("d", [1, 2])
def test_diag_system_matches_jax(typ, d):
    obs, times, ids, par = _data(d, 120, 7 + d)
    par = par[:, :d + (1 if typ == "BM_SSM" else 2)]
    ref = jdf.diag_system(typ, jnp.asarray(par), obs, times, ids, 0.3)
    got = tdf.diag_system(typ, torch.tensor(par), obs, times, ids, 0.3)
    if typ == "BM_SSM":  # centred: yd = y - g, c = c_ref - (g_i - g_{i-1})
        g = torch.tensor(tdf._reference_path(obs))
        got = got._replace(yd=got.yd + g,
                           c=got.c + torch.diff(g, dim=1, prepend=g[:, :1]))
    for k in ("t", "q", "c", "yd", "h"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    for k, rk in (("resetf", "reset"), ("prevf", "prev_reset"),
                  ("updatef", "update")):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, rk), float))
    assert got.p0 == ref.p0 == 10.0

    # vectorized elements and the llk recovery from filtered moments
    for e, r in zip(tdf.diag_elements(got), jdf.diag_elements(ref)):
        _close(e, r, tol=1e-12)
    rng = np.random.default_rng(1)
    bf = rng.normal(size=(d, 120))
    Cf = rng.uniform(0.1, 1.0, size=(d, 120))
    v = tdf.diag_llk_from_filtered(got, torch.tensor(bf), torch.tensor(Cf))
    rv = jdf.diag_llk_from_filtered(ref, jnp.asarray(bf), jnp.asarray(Cf))
    assert float(v) == pytest.approx(float(rv), rel=1e-12)
