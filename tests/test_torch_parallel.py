"""parallel/batching.py and parallel/time_scan.py of the port against the
JAX package, in f64 on the CPU (the cases of tests/test_parallel.py on
the same data and seeds).

- `pack_tracks` gives the JAX package's padded batch;
- the time-sharded full-state filter (`kalman_filter_time_sharded`) at 8
  and 4 shards, both local scans, against the JAX package's sharded
  filter on conftest's 8-device mesh and its sequential filter: value
  1e-10 relative, the gradient through the sharded composition 1e-8 of
  its largest component;
- `batched_loglik` over packed tracks, whole and in `shard_batch`'s 8
  shards, against the JAX flat filter;
- `soa_sharded_prefix_scan` against the unsharded `_scan_elements`;
- `Mesh`, `make_mesh`, `auto_mesh`: shards on one device; no card, no
  CUDA mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from jax.sharding import NamedSharding, PartitionSpec as P

from smoothsde_tpu.models.ssm import ctcrw_steps as jax_ctcrw_steps
from smoothsde_tpu.ops.kalman import (
    kalman_loglik_sequential as jax_kalman_loglik_sequential,
)
from smoothsde_tpu.parallel.batching import make_mesh as jax_make_mesh
from smoothsde_tpu.parallel.batching import pack_tracks as jax_pack_tracks
from smoothsde_tpu.parallel.time_scan import (
    kalman_filter_time_sharded as jax_kalman_filter_time_sharded,
)
from smoothsde_tpu_torch.models.ssm import ctcrw_steps
from smoothsde_tpu_torch.ops.kalman import kalman_loglik_sequential
from smoothsde_tpu_torch.parallel.batching import (
    Mesh,
    PackedTracks,
    auto_mesh,
    batched_loglik,
    make_mesh,
    pack_tracks,
    shard_batch,
)
from smoothsde_tpu_torch.parallel.time_scan import (
    kalman_filter_time_sharded,
    soa_sharded_prefix_scan,
)

F64 = torch.float64


def _ctcrw_data(seed, n, n_tracks=1):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.2, 0.8, size=n))
    ids = np.sort(rng.integers(0, n_tracks, size=n))
    obs = np.cumsum(rng.normal(size=(n, 2)) * 0.3, axis=0)
    par = np.tile([0.0, 0.0, np.log(2.0), np.log(1.0)], (n, 1))
    return par, obs, times, ids


def _assert_grad(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= 1e-8 * np.max(np.abs(want))


def test_pack_tracks_matches_jax():
    par, obs, times, ids = _ctcrw_data(0, 500, n_tracks=5)
    got = pack_tracks(obs, times, ids, pad_multiple=64, device="cpu")
    want = jax_pack_tracks(obs, times, ids, pad_multiple=64)
    assert got.obs.shape[0] == len(np.unique(ids))
    assert got.obs.shape[1] % 64 == 0
    assert int(got.lengths.sum()) == 500
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("local_scan", ["associative", "sequential"])
def test_time_sharded_filter_matches_jax_8_shards(local_scan):
    n = 512
    par, obs, times, ids = _ctcrw_data(1, n, n_tracks=3)
    obs[100] = np.nan
    steps = ctcrw_steps(torch.tensor(par), obs, times, ids, sigma_obs=0.2)
    got, m_f = kalman_filter_time_sharded(
        steps, make_mesh(8, "time", device="cpu"), "time", local_scan)
    jsteps = jax_ctcrw_steps(jnp.asarray(par), jnp.asarray(obs),
                             jnp.asarray(times), ids, sigma_obs=0.2)
    jmesh = jax_make_mesh(8, axis="time")
    sharded = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(jmesh, P("time"))), jsteps)
    want, jm_f = jax.jit(lambda s: jax_kalman_filter_time_sharded(
        s, jmesh, axis="time", local_scan="sequential"))(sharded)
    seq = float(jax_kalman_loglik_sequential(jsteps)[0])
    assert float(got) == pytest.approx(float(want), rel=1e-10)
    assert float(got) == pytest.approx(seq, rel=1e-10)
    np.testing.assert_allclose(m_f.numpy(), np.asarray(jm_f), rtol=0,
                               atol=1e-10 * float(np.abs(jm_f).max()))


@pytest.mark.parametrize("local_scan", ["associative", "sequential"])
def test_gradient_through_the_sharded_scan(local_scan):
    """torch.autograd through the sharded composition (the local scans,
    the gathered totals, the prefix fold) against jax.grad of the JAX
    sequential filter, 4 shards."""
    n = 256
    par, obs, times, ids = _ctcrw_data(5, n, n_tracks=2)
    obs[50] = np.nan
    theta0 = np.array([0.1, -0.05, np.log(2.0), np.log(1.0)])
    mesh = make_mesh(4, "time", device="cpu")
    theta = torch.tensor(theta0, requires_grad=True)
    steps = ctcrw_steps(theta.expand(n, 4), obs, times, ids, sigma_obs=0.2)
    v = kalman_filter_time_sharded(steps, mesh, "time", local_scan)[0]
    (g,) = torch.autograd.grad(v, theta)

    def llk_seq(th):
        s = jax_ctcrw_steps(jnp.broadcast_to(th, (n, 4)), jnp.asarray(obs),
                            jnp.asarray(times), ids, sigma_obs=0.2)
        return jax_kalman_loglik_sequential(s)[0]

    v_ref, g_ref = jax.value_and_grad(llk_seq)(jnp.asarray(theta0))
    assert float(v.detach()) == pytest.approx(float(v_ref), rel=1e-10)
    _assert_grad(g.numpy(), g_ref)


def _per_track(par_row):
    def per_track(o, t, length):
        L = o.shape[0]
        o = torch.where((torch.arange(L) < length)[:, None], o, torch.nan)
        steps = ctcrw_steps(torch.tensor(par_row).expand(L, 4), o.numpy(),
                            t.numpy(), np.zeros(L, int), sigma_obs=0.2)
        return kalman_loglik_sequential(steps)

    return per_track


@pytest.mark.parametrize("shards", [None, 8])
def test_batched_tracks_match_the_flat_filter(shards):
    """batched_loglik over the padded tracks (whole, or shard_batch's 8
    shards) against the JAX flat sequential filter."""
    par_row = np.array([0.0, 0.0, np.log(2.0), np.log(1.0)])
    n, K = 600, 6
    rng = np.random.default_rng(3)
    times = np.cumsum(rng.uniform(0.2, 0.8, size=n))
    ids = np.repeat(np.arange(K), n // K)
    obs = np.cumsum(rng.normal(size=(n, 2)) * 0.3, axis=0)
    want = float(jax_kalman_loglik_sequential(jax_ctcrw_steps(
        jnp.asarray(np.tile(par_row, (n, 1))), jnp.asarray(obs),
        jnp.asarray(times), ids, sigma_obs=0.2))[0])
    packed = pack_tracks(obs, times, ids, pad_multiple=32, device="cpu")
    if shards is not None:
        packed = shard_batch(packed, make_mesh(shards, device="cpu"))
        assert len(packed) == 8 and all(isinstance(p, PackedTracks)
                                        for p in packed)
        assert sum(p.obs.shape[0] for p in packed) == K
    got = batched_loglik(_per_track(par_row), packed)
    assert float(got) == pytest.approx(want, rel=1e-10)


@pytest.mark.parametrize("kind", ["ctcrw", "diag"])
@pytest.mark.parametrize("local_scan", ["sequential", "associative",
                                        "blocked"])
def test_soa_sharded_prefix_scan_matches_the_flat_scan(kind, local_scan):
    from smoothsde_tpu_torch.ops import diag_fused as df
    from smoothsde_tpu_torch.ops.kalman_soa import (
        _ID1,
        _ID2,
        _comb1,
        _combine2,
        _ctcrw_system,
        _scan_elements,
    )
    from smoothsde_tpu_torch.ops.scan_utils import elem_kind

    par, obs, times, ids = _ctcrw_data(7, 301, n_tracks=3)
    obs[40] = np.nan
    pm = torch.tensor(par)
    if kind == "ctcrw":
        comb, ident = _combine2, _ID2
        elems = _ctcrw_system(pm, obs, times, ids, 0.2).elem
    else:
        comb, ident = _comb1, _ID1
        elems = df.diag_elements(df.diag_system(
            "OU_SSM", pm, obs, times, ids, 0.2))
    got = soa_sharded_prefix_scan(comb, ident, elems,
                                  make_mesh(5, "time", device="cpu"), "time",
                                  local_scan)
    want = _scan_elements(comb, ident, elems, "sequential")
    pack = elem_kind(comb).pack
    for g, w in zip(pack(got), pack(want)):
        w = w.expand(g.shape)
        assert float((g - w).abs().max()) <= 1e-10 * max(
            1.0, float(w.abs().max()))


def test_meshes():
    mesh = make_mesh(8, "time", device="cpu")
    assert mesh.shape["time"] == 8 and mesh.n_cards == 1
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert auto_mesh(device="cpu").shape["tracks"] == 1
    assert Mesh(["cuda:0", "cuda:1"]).n_cards == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            auto_mesh()
