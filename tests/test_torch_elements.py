"""PyTorch port vs JAX package: filtering / smoothing element algebra
(`_combine2`, `_combine2_rev`, `_elem_from_vals`, `_par_terms_vals`,
`_smooth_elem_vals`) on the same random f64 inputs, to 1e-13 relative.

Also pins the two properties the fused kernels rely on: zero padding
evaluates to the identity element, and the combines are applied in the
right orientation (they do not commute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops import ctcrw_fused as jcf
from smoothsde_tpu.ops import kalman_smooth as jks
from smoothsde_tpu.ops import kalman_soa as jsoa
from smoothsde_tpu_torch.ops import ctcrw_fused as tcf
from smoothsde_tpu_torch.ops import kalman_smooth as tks
from smoothsde_tpu_torch.ops import kalman_soa as tsoa

TOL = 1e-13
M = 64  # lanes


def _close(got, ref, tol=TOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _random_filter_elem(rng):
    """Well-conditioned filtering element: A a contraction, C and J
    symmetric positive semi-definite, as composed elements are."""
    def psd():
        a = rng.normal(size=(2, M)) * 0.5
        b = rng.normal(size=(2, M)) * 0.5
        return (a[0] ** 2 + b[0] ** 2, a[0] * a[1] + b[0] * b[1],
                a[1] ** 2 + b[1] ** 2)

    C00, C01, C11 = psd()
    J00, J01, J11 = psd()
    A = 0.9 * np.eye(2)[:, :, None] + 0.2 * rng.normal(size=(2, 2, M))
    return [A[0, 0], A[0, 1], A[1, 0], A[1, 1], *rng.normal(size=(2, M)),
            C00, C01, C11, *rng.normal(size=(2, M)), J00, J01, J11]


def _random_smooth_elem(rng):
    E = 0.8 * np.eye(2)[:, :, None] + 0.2 * rng.normal(size=(2, 2, M))
    a = rng.normal(size=(2, M))
    return [E[0, 0], E[0, 1], E[1, 0], E[1, 1], *rng.normal(size=(2, M)),
            a[0] ** 2 + 0.1, a[0] * a[1] * 0.5, a[1] ** 2 + 0.1]


def _both(vals):
    return ([jnp.asarray(v) for v in vals], [torch.tensor(v) for v in vals])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combine2_matches_jax(seed):
    rng = np.random.default_rng(seed)
    (ja, ta), (jb, tb) = (_both(_random_filter_elem(rng)) for _ in range(2))
    ref = jcf._pack_elem(jsoa._combine2(jcf._unpack_elem_full(ja),
                                        jcf._unpack_elem_full(jb)))
    got = tcf._pack_elem(tsoa._combine2(tcf._unpack_elem_full(ta),
                                        tcf._unpack_elem_full(tb)))
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combine2_rev_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    (ja, ta), (jb, tb) = (_both(_random_smooth_elem(rng)) for _ in range(2))
    ref = jcf._pack_sm(jks._combine2_rev(jcf._unpack_sm(ja),
                                         jcf._unpack_sm(jb)))
    got = tcf._pack_sm(tks._combine2_rev(tcf._unpack_sm(ta),
                                         tcf._unpack_sm(tb)))
    for g, r in zip(got, ref):
        _close(g, r)


def _random_par(rng, R):
    lt = np.log(rng.uniform(0.3, 20.0, size=M))
    ln = np.log(rng.uniform(0.1, 5.0, size=M))
    # u = dt / tau spans both sides of the 0.6 series cutoff
    dtv = np.exp(lt) * np.geomspace(1e-6, 20.0, M)
    m = rng.normal(size=M)
    return [lt, ln, dtv, m, R]


@pytest.mark.parametrize("masked", [False, True])
def test_par_terms_vals_match_jax(masked):
    rng = np.random.default_rng(3)
    R = (rng.uniform(size=M) < 0.3).astype(float) if masked else np.zeros(M)
    ja, ta = _both(_random_par(rng, R))
    ref = jcf._par_terms_vals(*ja)
    got = tcf._par_terms_vals(*ta)
    assert set(ref) == set(got)
    for k in ref:
        _close(got[k], ref[k])


def test_elem_from_vals_matches_jax():
    rng = np.random.default_rng(4)
    w = tcf._par_terms_vals(*[torch.tensor(v) for v in _random_par(
        rng, np.zeros(M))])
    vals = [w[k].numpy() for k in ("f01", "f11", "q00", "q01", "q11",
                                   "c0", "c1")]
    y = rng.normal(size=M)
    # every (reset, update) combination of the three-way select
    R = np.tile([1.0, 0.0, 0.0, 1.0], M // 4)
    U = np.tile([0.0, 1.0, 0.0, 1.0], M // 4)
    ja, ta = _both(vals + [y, R, U])
    ref = jcf._pack_elem(jcf._elem_from_vals(*ja, 1.0, 10.0, 0.04))
    got = tcf._pack_elem(tcf._elem_from_vals(*ta, 1.0, 10.0, 0.04))
    for g, r in zip(got, ref):
        _close(g, r)


def test_smooth_elem_vals_matches_jax():
    rng = np.random.default_rng(5)
    w = tcf._par_terms_vals(*[torch.tensor(v) for v in _random_par(
        rng, np.zeros(M))])
    vals = [w[k].numpy() for k in ("f01", "f11", "q00", "q01", "q11",
                                   "c0", "c1")]
    a = rng.normal(size=(2, M))
    mom = [rng.normal(size=M), rng.normal(size=M), a[0] ** 2 + 0.2,
           0.3 * a[0] * a[1], a[1] ** 2 + 0.2]
    TE = (rng.uniform(size=M) < 0.2).astype(float)
    ja, ta = _both(vals + mom + [TE])
    (re, rG), (ge, gG) = jcf._smooth_elem_vals(*ja), tcf._smooth_elem_vals(*ta)
    for g, r in zip(tcf._pack_sm(ge) + list(gG), jcf._pack_sm(re) + list(rG)):
        _close(g, r)


def test_zero_padding_is_identity():
    """A padding slot (all-zero par and masks) must give the identity
    filtering element, and with any positive-definite filtered moments
    the identity smoothing element (up to roundoff)."""
    z = torch.zeros(M, dtype=torch.float64)
    w = tcf._par_terms_vals(z, z, z, z, z)
    assert torch.equal(w["f01"], z) and torch.equal(w["f11"], z + 1)
    for k in ("q00", "q01", "q11", "c0", "c1"):
        assert torch.equal(w[k], z), k
    e = tcf._elem_from_vals(w["f01"], w["f11"], w["q00"], w["q01"],
                            w["q11"], w["c0"], w["c1"], z, z, z, 1.0, 10.0,
                            0.04)
    for got, idv in zip(tcf._pack_elem(e), tcf._ID_VALS):
        assert torch.equal(got, torch.full_like(z, idv))
    rng = np.random.default_rng(6)
    a = torch.tensor(rng.normal(size=(2, M)))
    sm, _ = tcf._smooth_elem_vals(
        w["f01"], w["f11"], w["q00"], w["q01"], w["q11"], w["c0"], w["c1"],
        a[0], a[1], a[0] ** 2 + 0.5, 0.2 * a[0] * a[1], a[1] ** 2 + 0.5, z,
    )
    for got, idv in zip(tcf._pack_sm(sm), tcf._ID_SM):
        np.testing.assert_allclose(got.numpy(), idv, atol=1e-14)


def test_combines_do_not_commute():
    """Orientation matters: _combine2(earlier, later) and
    _combine2_rev(acc, new) give other results with arguments swapped,
    so a wrongly oriented prefix would be caught by value tests."""
    rng = np.random.default_rng(7)
    a = tcf._unpack_elem_full([torch.tensor(v) for v in
                               _random_filter_elem(rng)])
    b = tcf._unpack_elem_full([torch.tensor(v) for v in
                               _random_filter_elem(rng)])
    ab = torch.stack(tcf._pack_elem(tsoa._combine2(a, b)))
    ba = torch.stack(tcf._pack_elem(tsoa._combine2(b, a)))
    assert (ab - ba).abs().max() > 1e-3
    s = tcf._unpack_sm([torch.tensor(v) for v in _random_smooth_elem(rng)])
    t = tcf._unpack_sm([torch.tensor(v) for v in _random_smooth_elem(rng)])
    st = torch.stack(tcf._pack_sm(tks._combine2_rev(s, t)))
    ts = torch.stack(tcf._pack_sm(tks._combine2_rev(t, s)))
    assert (st - ts).abs().max() > 1e-3
