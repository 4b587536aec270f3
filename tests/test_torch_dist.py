"""The sharded likelihoods of parallel/dist.py and `SDE.fit(mesh=...)` on
the port against the JAX package, in f64 on the CPU: the cases of
tests/test_dist.py on the same data and seeds, on meshes of CPU shards
(`make_mesh(8, ..., device="cpu")`, conftest's 8 virtual devices' counterpart).

- tracks: CTCRW with a smooth, BM with a smooth, OU_SSM and BM_SSM, the
  joint nllk and its gradient (outer and inner) and the twin's value
  against the JAX flat bundle, BM also against the JAX package's own
  track-sharded builder; 5 uneven tracks on 8 shards (empty shards);
- time: the chunk-edge geometry of test_ctcrw_fused_time_sharded_parity
  (n = 700 on 8 shards, a reset on a chunk's first slot, a NaN row) for
  CTCRW (at 1, 2, 3 and 8 shards), BM_SSM and OU_SSM, the kernel cores
  (their plain op tables) and their twin against the JAX sequential
  filter and, at 8 shards, the JAX package's time-sharded builder; at 8
  shards also parameter rows that vary from row to row (the gradient of
  every row), and CTCRW with smooths through the bundle;
- ESEAL_SSM and a per-row H on both axes against the JAX flat bundle;
- the `stitch` hooks of the par-space, element-space and scalar-state
  filters and backwards: two chunks stitched give the whole sequence's
  llk, moments and cotangents;
- the Laplace marginal through a mesh on both axes against the flat one;
- fits with a mesh on both axes and with mesh="auto" against the flat
  fits; optimizer="device" on a one-device mesh, refused over two cards.

Bars: value 1e-10 relative, gradients 1e-8 of the largest component,
fits' nllk 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from test_dist import _eseal_multitrack, _multitrack_data

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu.ops.kalman_soa import ctcrw_loglik_soa as jax_ctcrw_soa
from smoothsde_tpu.ops.kalman_soa import diag_ssm_loglik_soa as jax_diag_soa
from smoothsde_tpu.ops.kalman_soa import precompute_dt as jax_precompute_dt
from smoothsde_tpu.parallel.batching import make_mesh as jax_make_mesh
from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.models.registry import get_model_spec
from smoothsde_tpu_torch.parallel import dist
from smoothsde_tpu_torch.parallel.batching import Mesh, make_mesh

F64 = torch.float64


def _mesh(axis, n=8):
    return make_mesh(n, axis, device="cpu")


def _close(got, want, rel=1e-10):
    assert got == pytest.approx(want, rel=rel)


def _grad_close(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    if want.size == 0:
        return
    assert np.max(np.abs(got - want)) <= 1e-8 * np.max(np.abs(want))


def _point(packer, seed, scale):
    rng = np.random.default_rng(seed)
    outer = packer.outer_init() + scale * rng.normal(
        size=packer.outer_init().shape)
    inner = packer.inner_init() + scale * rng.normal(
        size=packer.inner_init().shape)
    return outer, inner


def _port_value_grads(bundle, outer, inner):
    """(joint nllk, d/d outer, d/d inner, the twin's joint nllk)."""
    o = torch.tensor(outer, requires_grad=True)
    i = torch.tensor(inner, requires_grad=True)
    v = bundle.joint_nllk(bundle.packer.unpack(o, i))
    go, gi = torch.autograd.grad(v, (o, i), allow_unused=True)
    gi = torch.zeros_like(i) if gi is None else gi
    with torch.no_grad():
        ad = bundle.joint_nllk_ad(bundle.packer.unpack(o, i))
    return float(v.detach()), go.numpy(), gi.numpy(), float(ad)


def _jax_value_grads(bundle, outer, inner):
    pk = bundle.packer
    o, i = jnp.asarray(outer), jnp.asarray(inner)
    v = float(bundle.joint_nllk(pk.unpack(o, i)))
    go = jax.grad(lambda x: bundle.joint_nllk(pk.unpack(x, i)))(o)
    gi = jax.grad(lambda x: bundle.joint_nllk(pk.unpack(o, x)))(i)
    return v, np.asarray(go), np.asarray(gi)


def _parity(kw, mesh, axis, seed, scale, jax_flat=True, jax_mesh=False):
    """The port's sharded bundle against its flat one and the JAX
    package's (flat, and track-sharded with jax_mesh)."""
    b_sh = SDE(**kw, device="cpu", dtype=F64).setup(mesh=mesh,
                                                   mesh_axis=axis)
    b_flat = SDE(**kw, device="cpu", dtype=F64).setup()
    assert b_sh.uses_mesh and not b_flat.uses_mesh
    outer, inner = _point(b_flat.packer, seed, scale)
    v, go, gi, ad = _port_value_grads(b_sh, outer, inner)
    vf, gof, gif, adf = _port_value_grads(b_flat, outer, inner)
    _close(v, vf)
    _close(ad, adf)
    _grad_close(go, gof)
    _grad_close(gi, gif)
    if jax_flat:
        jv, jgo, jgi = _jax_value_grads(JaxSDE(**kw).setup(), outer, inner)
        _close(v, jv)
        _grad_close(go, jgo)
        _grad_close(gi, jgi)
    if jax_mesh:
        sv, sgo, sgi = _jax_value_grads(
            JaxSDE(**kw).setup(mesh=jax_make_mesh(8, axis=axis)), outer,
            inner)
        _close(v, sv)
        _grad_close(go, sgo)
        _grad_close(gi, sgi)


TRACK_CASES = {
    "CTCRW": (["y1", "y2"], {"mu1": "~1", "mu2": "~1",
                             "tau": "~s(x, k=5, bs='ts')", "nu": "~1"},
              [0.0, 0.0, 1.0, 1.0]),
    "BM": (["y1", "y2"], {"mu1": "~1", "mu2": "~1",
                          "sigma": "~s(x, k=5, bs='ts')"}, [0.0, 0.0, 1.0]),
    "OU_SSM": (["y1", "y2"], {"mu1": "~1", "mu2": "~1", "tau": "~1",
                              "kappa": "~1"}, [0.0, 0.0, 1.0, 1.0]),
    "BM_SSM": (["y1", "y2"], {"mu1": "~1", "mu2": "~1", "sigma": "~1"},
               [0.0, 0.0, 1.0]),
}


@pytest.mark.parametrize("typ", list(TRACK_CASES))
def test_tracks_sharded_value_and_grad(typ):
    resp, formulas, par0 = TRACK_CASES[typ]
    kw = dict(formulas=formulas, data=_multitrack_data(), type=typ,
              response=resp, par0=par0)
    _parity(kw, _mesh("tracks"), "tracks", 1, 0.05, jax_mesh=typ == "BM")


def test_uneven_tracks_and_empty_shards():
    """5 tracks of different lengths on 8 shards: three shards hold
    nothing, and the sharded likelihood is the flat one (the port's flat
    CTCRW bundle is held to the JAX package's by the cases above)."""
    rng = np.random.default_rng(3)
    lens = [11, 23, 7, 31, 17]
    ids = np.concatenate([np.full(m, k) for k, m in enumerate(lens)])
    times = np.concatenate([np.cumsum(rng.uniform(0.3, 0.8, m))
                            for m in lens])
    obs = np.cumsum(rng.normal(size=(ids.size, 2)) * 0.3, axis=0)
    kw = dict(data={"ID": ids, "time": times, "y1": obs[:, 0],
                    "y2": obs[:, 1]},
              type="CTCRW", response=["y1", "y2"], par0=[0.0, 0.0, 1.0, 1.0])
    _parity(kw, _mesh("tracks"), "tracks", 2, 0.0, jax_flat=False)


# ---- the time axis: the chunk-edge geometry ----

N_EDGE = 700
THETA = {"CTCRW": [0.1, -0.2, np.log(2.0), np.log(1.0)],
         "BM_SSM": [0.1, -0.2, np.log(0.8)],
         "OU_SSM": [0.1, -0.2, np.log(2.0), np.log(0.6)]}


def _edge_data(typ):
    """n = 700: 8 chunks of 88 / 87 steps; the track boundary at 264 lies
    on chunk 3's first slot, the one at 300 inside it; row 50 is NaN."""
    rng = np.random.default_rng(3 if typ == "CTCRW" else 4)
    times = np.cumsum(rng.uniform(0.4, 0.6, size=N_EDGE))
    obs = np.cumsum(rng.normal(size=(N_EDGE, 2)) * 0.3, axis=0)
    obs[50, :] = np.nan
    ids = np.concatenate([np.zeros(264, np.int32), np.full(36, 1, np.int32),
                          np.full(400, 2, np.int32)])
    return obs, times, ids


def _edge_rows(typ, varying):
    """(n, k) parameter rows: THETA on every row, or with `varying` THETA
    plus a seeded walk, so that a chunk's entering row and the score's
    slot at every edge are read from the row they belong to."""
    theta = np.asarray(THETA[typ])
    if not varying:
        return np.broadcast_to(theta, (N_EDGE, theta.size))
    walk = np.cumsum(np.random.default_rng(11).normal(
        size=(N_EDGE, theta.size)), axis=0)
    return theta + 0.3 * np.sin(walk / 8.0)


@functools.lru_cache(maxsize=None)
def _jax_edge_reference(typ, varying=False):
    """The JAX package's sequential SoA filter at `_edge_rows`: the value
    and the gradient of every row."""
    obs, times, ids = _edge_data(typ)
    dt = jnp.asarray(jax_precompute_dt(times, ids))

    def f(pm):
        args = (pm, jnp.asarray(obs), jnp.asarray(times), ids)
        if typ == "CTCRW":
            return jax_ctcrw_soa(*args, sigma_obs=0.1, scan="sequential",
                                 dt=dt)
        return jax_diag_soa(typ, *args, sigma_obs=0.1, scan="sequential",
                            dt=dt)

    v, g = jax.jit(jax.value_and_grad(f))(
        jnp.asarray(_edge_rows(typ, varying)))
    return float(v), np.asarray(g)


def _edge_value_grad(fn, typ):
    th = torch.tensor(THETA[typ], requires_grad=True)
    full = {"log_sigma_obs": torch.tensor([np.log(0.1)], dtype=F64)}
    v = fn(full, th.expand(N_EDGE, len(THETA[typ])))
    (g,) = torch.autograd.grad(v, th)
    return float(v.detach()), g.numpy()


def _jax_time_sharded(typ):
    """The JAX package's own time-sharded builder on conftest's 8-device
    mesh (its CPU route: the SoA scan, sequential within a device)."""
    from jax.sharding import Mesh as JaxMesh

    from smoothsde_tpu.models.registry import get_model_spec as jax_spec
    from smoothsde_tpu.parallel.dist import build_time_sharded_loglik

    obs, times, ids = _edge_data(typ)
    loglik = build_time_sharded_loglik(
        jax_spec(typ, 2), obs, times, ids,
        JaxMesh(np.array(jax.devices()), ("time",)), "time")
    full = {"log_sigma_obs": jnp.asarray([np.log(0.1)])}
    k = len(THETA[typ])
    v, g = jax.jit(jax.value_and_grad(lambda th: loglik(
        full, jnp.broadcast_to(th, (N_EDGE, k)))))(jnp.asarray(THETA[typ]))
    return float(v), np.asarray(g)


@pytest.mark.parametrize("typ,shards", [("CTCRW", 1), ("CTCRW", 2),
                                        ("CTCRW", 3), ("CTCRW", 8),
                                        ("BM_SSM", 8), ("OU_SSM", 8)])
def test_time_sharded_chunk_edges(typ, shards):
    """The port's kernel cores (their plain op tables) and twin against
    the JAX sequential filter, and at 8 shards against the JAX package's
    own time-sharded builder."""
    obs, times, ids = _edge_data(typ)
    sh = dist.build_time_sharded_loglik(
        get_model_spec(typ, 2), obs, times, ids, _mesh("time", shards),
        "time", dtype=F64, device="cpu")
    v, g = _jax_edge_reference(typ)
    refs = [(v, g.sum(axis=0))]
    if shards == 8:
        refs.append(_jax_time_sharded(typ))
    for fn in (sh.loglik, sh.loglik_ad):
        v, g = _edge_value_grad(fn, typ)
        for want_v, want_g in refs:
            _close(v, want_v)
            _grad_close(g, want_g)


@pytest.mark.parametrize("typ", ["CTCRW", "BM_SSM", "OU_SSM"])
def test_time_sharded_varying_rows(typ):
    """Parameter rows that vary from row to row on the chunk-edge
    geometry, 8 shards: the kernel cores (their plain op tables) and the
    twin against the JAX sequential filter, value and the gradient of
    every row."""
    obs, times, ids = _edge_data(typ)
    sh = dist.build_time_sharded_loglik(
        get_model_spec(typ, 2), obs, times, ids, _mesh("time"), "time",
        dtype=F64, device="cpu")
    want_v, want_g = _jax_edge_reference(typ, varying=True)
    full = {"log_sigma_obs": torch.tensor([np.log(0.1)], dtype=F64)}
    for fn in (sh.loglik, sh.loglik_ad):
        pm = torch.tensor(_edge_rows(typ, True), requires_grad=True)
        v = fn(full, pm)
        (g,) = torch.autograd.grad(v, pm)
        _close(float(v.detach()), want_v)
        _grad_close(g.numpy(), want_g)


def test_time_sharded_ctcrw_with_smooths():
    """CTCRW on the chunk-edge data, 8 time shards, with tau ~ s(x), nu
    and mu1 linear in x: every parameter row differs. The joint nllk and
    its gradient in every coefficient against the port's flat bundle and
    the JAX package's."""
    obs, times, ids = _edge_data("CTCRW")
    x = np.sin(times / 40.0)
    kw = dict(formulas={"mu1": "~x", "mu2": "~1",
                        "tau": "~s(x, k=5, bs='ts')", "nu": "~x"},
              data={"ID": ids, "time": times, "x": x, "y1": obs[:, 0],
                    "y2": obs[:, 1]},
              type="CTCRW", response=["y1", "y2"], par0=[0.0, 0.0, 1.0, 1.0])
    _parity(kw, _mesh("time"), "time", 5, 0.1)


def test_time_sharding_refuses_closed_form_and_too_few_steps():
    obs, times, ids = _edge_data("CTCRW")
    with pytest.raises(NotImplementedError):
        dist.build_time_sharded_loglik(get_model_spec("BM", 2), obs, times,
                                       ids, _mesh("time"), dtype=F64)
    with pytest.raises(ValueError, match="cannot fill"):
        dist.build_time_sharded_loglik(get_model_spec("CTCRW", 2), obs[:5],
                                       times[:5], ids[:5], _mesh("time"),
                                       dtype=F64)


# ---- the generic route: ESEAL_SSM and a per-row H on both axes ----


def _h_kw():
    data = _multitrack_data(seed=9)
    n = len(data["time"])
    rng = np.random.default_rng(4)
    H = np.einsum("ni,nj->nij", rng.uniform(0.05, 0.3, size=(n, 2)),
                  np.ones((n, 2))) * np.eye(2)
    return dict(data=data, type="CTCRW", response=["y1", "y2"],
                other_data={"H": H}, par0=[0.0, 0.0, 1.0, 1.0])


def _eseal_kw(axis):
    data, other = (_eseal_multitrack() if axis == "tracks"
                   else _eseal_multitrack(K=1, Lk=90))
    return dict(data=data, type="ESEAL_SSM", response="z", other_data=other,
                par0=[0.0, 0.3])


@pytest.mark.parametrize("case", ["eseal", "H"])
@pytest.mark.parametrize("axis", ["tracks", "time"])
def test_generic_route_sharded(case, axis):
    kw = _eseal_kw(axis) if case == "eseal" else _h_kw()
    _parity(kw, _mesh(axis), axis, 2, 0.03)


# ---- the stitch hooks: two chunks give the whole sequence ----


def _stitch(elem, seed):
    """A stitch hook that keeps the chunk's total in `box` and returns
    `seed`, or the identity for None (the first chunk's prefix, the last
    chunk's suffix)."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    box = []

    def stitch(total):
        box.append(total)
        if seed is not None:
            return seed
        return cf.stitch_seeds(total[:, None], elem)[:, 0]

    return stitch, box


def _ctcrw_chunks(s):
    """The CTCRW chunk-edge data at f64, whole and cut at slot s."""
    from smoothsde_tpu_torch.ops.kalman_soa import (
        prepare_ctcrw_data,
        split_ctcrw_data,
    )

    obs, times, ids = _edge_data("CTCRW")
    data = prepare_ctcrw_data(obs, times, ids, dtype=F64, device="cpu")
    return data, split_ctcrw_data(data, [s, N_EDGE - s], ["cpu", "cpu"])


def test_par_space_stitch_hooks():
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    s = 264  # a reset on the second chunk's first slot
    data, chunks = _ctcrw_chunks(s)
    par = torch.tensor(THETA["CTCRW"]).expand(N_EDGE, 4).contiguous()
    h = torch.tensor([0.01], dtype=F64)
    ops = cf.OPS["plain"]
    p = cf.plan(2, N_EDGE)
    stack, bd = cf.par_stack_from_data(par, data.yd, data.dtv, data.resetf,
                                       data.validf, p)
    llk, mom = cf.fused_filter_par(stack, bd, h, p, 1.0, 10.0, ops)
    want = cf.par_cotangents(*ops.score_scan(
        stack, mom, ops.block_prefix(ops.smooth_totals(stack, mom), 2,
                                     "smooth", True), h, 1.0), 1.0, p)
    parts = [par[:s], par[s:]]
    st = []
    for r, c in enumerate(chunks):
        pp = cf.plan(2, parts[r].shape[0])
        prev = parts[0][-1] if r else parts[0][0]
        st.append((pp,) + cf.build_par_stack(
            parts[r][:, :2].T, parts[r][:, 2], parts[r][:, 3], c.dtv, c.te,
            c.tvn, c.yd, c.upd, c.rst, pp,
            ent=(prev[2], prev[3], c.dt_prev, prev[:2], c.prst0)))
    hook0, box0 = _stitch("filter", None)
    l0, m0 = cf.fused_filter_par(st[0][1], st[0][2], h, st[0][0], 1.0, 10.0,
                                 ops, stitch=hook0)
    hook1, _ = _stitch("filter", box0[0])
    l1, m1 = cf.fused_filter_par(st[1][1], st[1][2], h, st[1][0], 1.0, 10.0,
                                 ops, stitch=hook1)
    _close(float(l0 + l1), float(llk))
    got_m = torch.cat([cf.unstack(m0, st[0][0]), cf.unstack(m1, st[1][0])],
                      dim=-1)
    torch.testing.assert_close(got_m, cf.unstack(mom, p), rtol=0, atol=1e-10)
    hook1, box1 = _stitch("smooth", None)
    c1 = cf.fused_backward_par(st[1][1], m1, h, 1.0, st[1][0], 1.0, ops,
                               stitch=hook1)
    hook0, _ = _stitch("smooth", box1[0])
    c0 = cf.fused_backward_par(st[0][1], m0, h, 1.0, st[0][0], 1.0, ops,
                               stitch=hook0)
    for k in range(4):
        got = torch.cat([c0[k], c1[k]], dim=-1)
        _grad_close(got.numpy(), want[k].numpy())
    _close(float(c0[4] + c1[4]), float(want[4]))


def test_element_space_stitch_hook():
    """fused_filter(sys, stitch=): the element-space filter of two
    slices of one CtcrwSystem, the second seeded with the first's total,
    gives the whole system's llk (the JAX sequential filter's) and
    moments."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops.kalman_soa import _ctcrw_system

    obs, times, ids = _edge_data("CTCRW")
    pm = torch.tensor(THETA["CTCRW"]).expand(N_EDGE, 4)
    sys = _ctcrw_system(pm, obs, times, ids, torch.tensor(0.1, dtype=F64))
    ops = cf.ELEM_OPS["plain"]
    llk, mom = cf.fused_filter(sys, ops)
    _close(float(llk), _jax_edge_reference("CTCRW")[0])

    def cut(x, a, b):
        if isinstance(x, tuple):
            return tuple(cut(v, a, b) for v in x)
        return x[..., a:b] if isinstance(x, torch.Tensor) else x

    s = 300
    halves = [sys._replace(**{f: cut(getattr(sys, f), a, b) for f in (
        "Ft", "ct", "Qt", "yd", "reset", "prev_reset", "update")})
        for a, b in ((0, s), (s, N_EDGE))]
    hook0, box0 = _stitch("filter", None)
    l0, m0 = cf.fused_filter(halves[0], ops, stitch=hook0)
    hook1, _ = _stitch("filter", box0[0])
    l1, m1 = cf.fused_filter(halves[1], ops, stitch=hook1)
    _close(float(l0 + l1), float(llk))
    got = torch.cat([cf.unstack(m0, cf.plan(2, s)),
                     cf.unstack(m1, cf.plan(2, N_EDGE - s))], dim=-1)
    torch.testing.assert_close(got, cf.unstack(mom, cf.plan(2, N_EDGE)),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
def test_scalar_state_stitch_hooks(typ):
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import diag_fused as df

    obs, times, ids = _edge_data(typ)
    data = df.prepare_diag_data(typ, obs, times, ids, dtype=F64,
                                device="cpu")
    k = len(THETA[typ])
    par = torch.tensor(THETA[typ]).expand(N_EDGE, k)
    sysd = df.diag_system(typ, par, None, None, None,
                          torch.tensor(0.1, dtype=F64), data=data)
    h = sysd.h.reshape(1)
    ops = df.OPS["plain"]
    p = cf.plan(2, N_EDGE)
    llk, mom = df.diag_fwd(df.forward_stack(
        sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef, p),
        h, p, df.P0, ops)
    _close(float(llk), _jax_edge_reference(typ)[0])
    want = df.diag_bwd(df.backward_stack(
        sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef, p),
        mom, h, p, df.P0, ops)
    s = 264
    chunks = df.split_diag_data(data, [s, N_EDGE - s], ["cpu", "cpu"])
    rows = [df.diag_chunk_rows(typ, chunks[0], par[:s], par[0]),
            df.diag_chunk_rows(typ, chunks[1], par[s:], par[s - 1])]
    plans = [cf.plan(2, s), cf.plan(2, N_EDGE - s)]
    fst = [df.forward_stack(t[:-1], q[:-1], c[:, :-1], ch.yd, ch.resetf,
                            ch.updatef, pp)
           for (t, q, c), ch, pp in zip(rows, chunks, plans)]
    bst = [cf.stack_rows([t[1:], q[1:], c[:, 1:], ch.te, ch.tvn, ch.yd,
                          ch.updatef, ch.resetf], df._BWD_PAD, pp)
           for (t, q, c), ch, pp in zip(rows, chunks, plans)]
    hook0, box0 = _stitch("diag_filter", None)
    l0, m0 = df.diag_fwd(fst[0], h, plans[0], df.P0, ops, stitch=hook0)
    hook1, _ = _stitch("diag_filter", box0[0])
    l1, m1 = df.diag_fwd(fst[1], h, plans[1], df.P0, ops, stitch=hook1)
    _close(float(l0 + l1), float(llk))
    hook1, box1 = _stitch("diag_smooth", None)
    c1 = df.diag_bwd(bst[1], m1, h, plans[1], df.P0, ops, stitch=hook1)
    hook0, _ = _stitch("diag_smooth", box1[0])
    c0 = df.diag_bwd(bst[0], m0, h, plans[0], df.P0, ops, stitch=hook0)
    for k in range(4):
        _grad_close(torch.cat([c0[k], c1[k]], dim=-1).numpy(),
                    want[k].numpy())
    _close(float(c0[4] + c1[4]), float(want[4]))


# ---- the Laplace marginal and fits through a mesh ----


@pytest.mark.parametrize("axis", ["tracks", "time"])
def test_laplace_marginal_through_a_mesh(axis):
    """A smooth integrated out through the sharded likelihood and its
    sharded twin: the marginal's value and gradient equal the flat
    bundle's."""
    from smoothsde_tpu_torch.infer.fit import make_val_grad

    rng = np.random.default_rng(22)
    n, dt = 48, 0.5
    x = np.arange(n) / (n - 1)
    sig = 0.5 + 0.6 * np.sin(np.pi * x)
    lat = np.concatenate([[0.0], np.cumsum(
        sig[:-1] * np.sqrt(dt) * rng.normal(size=n - 1))])
    ids = np.zeros(n, int) if axis == "time" else np.repeat(np.arange(4), 12)
    kw = dict(formulas={"mu": "~1", "sigma": "~s(x, k=5, bs='cs')"},
              data={"ID": ids, "time": np.arange(n) * dt, "x": x,
                    "z": lat + 0.25 * rng.normal(size=n)},
              type="BM_SSM", response="z", par0=[0.0, 0.8])
    b_sh = SDE(**kw, device="cpu", dtype=F64).setup(
        mesh=_mesh(axis, 2 if axis == "tracks" else 4), mesh_axis=axis)
    b_flat = SDE(**kw, device="cpu", dtype=F64).setup()
    x = b_flat.packer.outer_init() + 0.05
    v, g, b = make_val_grad(b_sh)(x)
    vf, gf, bf = make_val_grad(b_flat)(x)
    _close(v, vf)
    _grad_close(g, gf)
    np.testing.assert_allclose(b, bf, rtol=0, atol=1e-8)


def _bm_tracks(seed=7, K=8, Lk=60, mu_t=0.5, sig_t=0.8):
    rng = np.random.default_rng(seed)
    rows = {"ID": [], "time": [], "z": []}
    for k in range(K):
        t = np.cumsum(rng.uniform(0.4, 0.6, Lk))
        z = np.concatenate([[0.0], np.cumsum(
            mu_t * np.diff(t) + sig_t * np.sqrt(np.diff(t))
            * rng.normal(size=Lk - 1))])
        rows["ID"].extend([k] * Lk)
        rows["time"].extend(t.tolist())
        rows["z"].extend(z.tolist())
    return {k: np.asarray(v) for k, v in rows.items()}


def _one_long_bm_ssm(n=997):
    rng = np.random.default_rng(13)
    dt = 0.5
    lat = np.concatenate([[0.0], np.cumsum(
        0.2 * dt + 0.7 * np.sqrt(dt) * rng.normal(size=n - 1))])
    return {"ID": np.zeros(n, int), "time": np.arange(n) * dt,
            "z": lat + 0.3 * rng.normal(size=n)}


@pytest.mark.parametrize("case", ["bm_tracks", "bm_ssm_time", "auto"])
def test_fit_with_a_mesh(case):
    """SDE.fit(mesh=...) on both axes, and mesh="auto" (the one CPU),
    against the port's flat fit and the JAX package's: the optimum's
    nllk 1e-6 relative, the estimates 1e-4."""
    if case == "bm_ssm_time":
        kw = dict(data=_one_long_bm_ssm(), type="BM_SSM", response="z",
                  par0=[0.0, 1.0])
        mesh, axis = _mesh("time"), "time"
    else:
        kw = dict(data=_bm_tracks(), type="BM", response="z",
                  par0=[0.0, 1.0])
        mesh, axis = (_mesh("tracks"), "tracks") if case == "bm_tracks" \
            else ("auto", "tracks")
    sh = SDE(**kw, device="cpu", dtype=F64)
    res = sh.fit(mesh=mesh, mesh_axis=axis, compute_sdreport=False)
    assert sh.bundle().uses_mesh and res.convergence == 0
    flat = SDE(**kw, device="cpu", dtype=F64).fit(compute_sdreport=False)
    want = JaxSDE(**kw).fit(compute_sdreport=False)
    for ref in (flat, want):
        assert abs(res.value - ref.value) <= 1e-6 * (1 + abs(ref.value))
        np.testing.assert_allclose(res.par, np.asarray(ref.par), atol=1e-4)


def test_device_optimizer_and_a_multi_card_mesh():
    """optimizer="device" runs on a one-device mesh and reaches the scipy
    optimum; with the mesh over two cards its steps run eagerly, the
    reason in `device_graph`, to the same optimum, and "auto" applies
    the JAX package's rule as without a mesh."""
    from smoothsde_tpu_torch.infer.fit import fit_model, resolve_optimizer

    kw = dict(data=_bm_tracks(), type="BM", response="z", par0=[0.0, 1.0])
    sde = SDE(**kw, device="cpu", dtype=F64)
    res = sde.fit(mesh=_mesh("tracks"), optimizer="device",
                  compute_sdreport=False)
    ref = SDE(**kw, device="cpu", dtype=F64).fit(compute_sdreport=False)
    assert res.optimizer == "device" and res.convergence == 0
    assert res.device_graph == "eager"
    assert abs(res.value - ref.value) <= 1e-6 * (1 + abs(ref.value))
    bundle = sde.bundle()
    bundle.mesh = Mesh(["cuda:0", "cuda:1"])
    two = fit_model(bundle, optimizer="device", compute_sdreport=False)
    assert two.optimizer == "device" and two.convergence == 0
    assert two.device_graph == "eager (2 cards)" and two.device_steps > 0
    assert abs(two.value - ref.value) <= 1e-6 * (1 + abs(ref.value))
    assert resolve_optimizer(bundle) == "scipy"  # a CPU model
    bundle.device = torch.device("cuda")
    assert resolve_optimizer(bundle) == "device"  # closed form on a card
