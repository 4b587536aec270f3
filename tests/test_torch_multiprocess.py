"""The port's multi-process ("dcn", axis) mesh against the JAX package, in
f64 on the CPU: two spawned processes (tests/torch_mp_worker.py) join a
gloo group, each with two CPU shards (one for mesh="auto"), and evaluate

- tracks: BASELINE config 4 cut to 8 x 60 steps, `tau ~ s(ID,
  bs='re')`, the joint nllk, its gradient (outer and inner) and the
  twin's value, and the Laplace marginal's value and gradient;
- time: a CTCRW and an OU_SSM of 2,000 steps (dcn 2 x time 2), the joint
  nllk, its gradient and the twin's value;
- a short OU_SSM fit with mesh="auto" on the time axis;
- optimizer="device" fits: that OU_SSM on the ("dcn", "time") mesh (the
  joint nllk, each step eager, the FD Hessian on the device) and a BM
  with `mu ~ s(ID, bs='re')` over 8 tracks on the ("dcn", "tracks")
  mesh (the Laplace marginal, then the host polish);
- `auto_mesh`'s shape (2, 1).

Bars: against the JAX package's flat single-process objective value
1e-10 relative, gradients 1e-8 of the largest component (the Laplace
marginal also against the JAX marginal); the two ranks' results equal
bit for bit (the device fits' estimates, values, steps, graphs and
counts among them); the scipy fit's estimates and nllk within 1e-8 of
the one-process port fit's; the device fits' estimates within 1e-8 and
nllk within 1e-10 relative of the one-process port device fit's, and
within 1e-4 / 1e-6 relative of the JAX package's flat fit. Each process
is joined with its own timeout.
"""

import multiprocessing
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mp_worker as worker
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu.infer.laplace import make_laplace as jax_make_laplace
from smoothsde_tpu_torch import SDE

F64 = torch.float64
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (rank 0's, rank 1's)."""
    out = tmp_path_factory.mktemp("mp")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, 2, os.path.join(out, "store"), str(out)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive, f"processes {alive} did not end in {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def _close(got, want, rel=1e-10):
    assert float(got) == pytest.approx(float(want), rel=rel)


def _grad_close(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-8 * np.max(np.abs(want))


def _jax_bundle(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxSDE(**kw).setup()


def _jax_value_grads(bundle, outer, inner):
    pk = bundle.packer
    o, i = jnp.asarray(outer), jnp.asarray(inner)
    v = float(bundle.joint_nllk(pk.unpack(o, i)))
    go = jax.grad(lambda x: bundle.joint_nllk(pk.unpack(x, i)))(o)
    gi = jax.grad(lambda x: bundle.joint_nllk(pk.unpack(o, x)))(i)
    return v, np.asarray(go), np.asarray(gi)


def test_auto_mesh_spans_the_processes(ranks):
    for res in ranks:
        assert res["auto_shape"].tolist() == [2, 1]


def test_ranks_agree_bit_for_bit(ranks):
    a, b = ranks
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_tracks_joint_matches_jax_flat(ranks):
    kw = worker.config4_cut()
    jb = _jax_bundle(kw)
    outer, inner = worker.point(jb.packer, 4, 0.2)
    jv, jgo, jgi = _jax_value_grads(jb, outer, inner)
    res = ranks[0]
    _close(res["tracks_v"][0], jv)
    _close(res["tracks_v"][1], jv)  # the twin
    _grad_close(res["tracks_go"], jgo)
    _grad_close(res["tracks_gi"], jgi)


def test_tracks_laplace_marginal_matches_jax_and_one_process(ranks):
    kw = worker.config4_cut()
    pb = SDE(**kw, device="cpu", dtype=F64).setup()
    outer, inner = worker.point(pb.packer, 4, 0.2)
    fv, fg = worker.marginal(pb, outer, inner)
    res = ranks[0]
    _close(res["tracks_mv"][0], fv[0])
    _grad_close(res["tracks_mg"], fg)
    jb = _jax_bundle(kw)
    jm = jax_make_laplace(jb.joint_nllk, jb.packer,
                          joint_nllk_ad=jb.joint_nllk_ad,
                          hess_plan=jb.hess_plan)
    (jv, _), jg = jax.value_and_grad(jm, has_aux=True)(
        jnp.asarray(outer), jnp.asarray(inner))
    _close(res["tracks_mv"][0], jv)
    _grad_close(res["tracks_mg"], jg)


@pytest.mark.parametrize("kind", ["CTCRW", "OU_SSM"])
def test_time_joint_matches_jax_flat(ranks, kind):
    jb = _jax_bundle(worker.time_case(kind))
    outer, inner = worker.point(jb.packer, 5, 0.1)
    jv, jgo, _ = _jax_value_grads(jb, outer, inner)
    res = ranks[0]
    _close(res[f"{kind}_v"][0], jv)
    _close(res[f"{kind}_v"][1], jv)  # the twin
    _grad_close(res[f"{kind}_go"], jgo)


def test_fit_matches_the_one_process_fit(ranks):
    one = SDE(**worker.time_case(worker.FIT_CASE), device="cpu",
              dtype=F64).fit(maxiter=worker.FIT_MAXITER)
    res = ranks[0]
    assert one.convergence == 0
    np.testing.assert_allclose(res["fit_par"], one.par, rtol=0, atol=1e-8)
    _close(res["fit_value"][0], one.value, rel=1e-8)
    np.testing.assert_allclose(res["fit_cov"], one.cov_fixed, rtol=1e-6,
                               atol=1e-12)


# the device fits: (npz tag, SDE keywords, fit keywords)
DEVICE_FITS = {
    "time": ("dev_time", lambda: worker.time_case(worker.FIT_CASE),
             dict(maxiter=worker.FIT_MAXITER)),
    "tracks": ("dev_tracks", worker.re_tracks,
               dict(compute_sdreport=False)),
}


@pytest.mark.parametrize("case", sorted(DEVICE_FITS))
def test_device_fit_matches_the_one_process_device_fit(ranks, case):
    """optimizer="device" over two processes: every step eager (the
    reason names the processes), the same optimum as one process's
    device fit, and for the time case the FD Hessian's covariance too."""
    tag, make, fit_kw = DEVICE_FITS[case]
    one = SDE(**make(), device="cpu", dtype=F64).fit(optimizer="device",
                                                     **fit_kw)
    res = ranks[0]
    assert one.optimizer == "device" and one.convergence == 0
    assert res[f"{tag}_conv"][0] == 0
    assert worker.graph_name(res[f"{tag}_graph"]) == \
        "eager (collectives across 2 processes)"
    np.testing.assert_allclose(res[f"{tag}_par"], one.par, rtol=0,
                               atol=1e-8)
    _close(res[f"{tag}_value"][0], one.value, rel=1e-10)
    if case == "time":
        np.testing.assert_allclose(res["dev_time_cov"], one.cov_fixed,
                                   rtol=1e-6, atol=1e-12)
    else:
        np.testing.assert_allclose(res["dev_tracks_bhat"], one.bhat,
                                   rtol=0, atol=1e-8)


@pytest.mark.parametrize("case", sorted(DEVICE_FITS))
def test_device_fit_matches_the_jax_flat_fit(ranks, case):
    tag, make, fit_kw = DEVICE_FITS[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JaxSDE(**make()).fit(**{**fit_kw,
                                       "compute_sdreport": False})
    res = ranks[0]
    assert abs(res[f"{tag}_value"][0] - want.value) \
        <= 1e-6 * abs(want.value)
    np.testing.assert_allclose(res[f"{tag}_par"], np.asarray(want.par),
                               rtol=0, atol=1e-4)
