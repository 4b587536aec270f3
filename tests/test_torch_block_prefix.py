"""PyTorch port vs JAX package: the cross-block prefix (kernel K2).

The port's plain block prefix (smoothsde_tpu_torch/ops/ctcrw_fused.py
block_prefix_plain, the CPU stand-in for csrc/block_prefix.cu) against
the JAX `_block_prefix_pallas` run in Pallas interpret mode, on the
same per-block totals: forward with `_combine2` (14-comp CTCRW
filtering elements) and `_comb1` (5-comp scalar-state ones), reverse
with `_combine2_rev` (9-comp smoothing elements) and `_comb1_rev`
(3-comp), NB = 256 blocks per dim, d = 2, atol 1e-12.

The totals are real ones: the port's plain K1a/K3a (D1a/D3a for the
scalar-state elements) on a simulated two-track record, so the elements
are as conditioned as in a fit.

`_tile_emulation` is a plain PyTorch emulation of the CUDA kernel's
multi-block decomposition (tile reduce, tile-total scan with a carry,
seeded rescan; the tile size a parameter). It is held, for every element
kind in both directions, against the sequential composition and against
the JAX kernel at block counts that cross the kernel's tile: NB in {1,
T - 1, T, T + 1, 3T + 5} for T = 256, d in {1, 3}, f64, atol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops import ctcrw_fused as jcf
from smoothsde_tpu.ops import diag_fused as jdf
from smoothsde_tpu.ops import kalman_smooth as jks
from smoothsde_tpu.ops import kalman_soa as jsoa
from smoothsde_tpu_torch.ops import ctcrw_fused as tcf
from smoothsde_tpu_torch.ops import diag_fused as tdf
from smoothsde_tpu_torch.ops.kalman_soa import prepare_ctcrw_data

D, NB = 2, 256
N = NB * tcf.STEPS_PER_LANE  # plan(D, N) gives exactly NB blocks


@pytest.fixture(scope="module")
def totals():
    rng = np.random.default_rng(11)
    times = np.cumsum(rng.uniform(0.2, 1.0, size=N))
    ids = (np.arange(N) >= N // 3).astype(int)
    obs = np.cumsum(rng.normal(size=(N, D)) * 0.2, axis=0)
    obs[rng.integers(0, N, size=40)] = np.nan
    p = tcf.plan(D, N)
    assert p.NB == NB
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device="cpu")
    par = torch.tensor(np.column_stack([
        0.05 * rng.normal(size=(N, D)),
        np.log(2.0) + 0.1 * rng.normal(size=N),
        np.log(0.7) + 0.1 * rng.normal(size=N),
    ]))
    stack, bd = tcf.par_stack_from_data(par, data.yd, data.dtv, data.resetf,
                                        data.validf, p)
    h = torch.tensor([0.01], dtype=torch.float64)
    ftot = tcf.filter_totals_plain(stack, bd, h, 1.0, 10.0)
    prefix = tcf.block_prefix_plain(ftot, D, "filter", False)
    moments, _ = tcf.filter_scan_plain(stack, bd, prefix, h, 1.0, 10.0)
    stot = tcf.smooth_totals_plain(stack, moments)

    sysd = tdf.diag_system("OU_SSM", par, obs, times, ids, 0.1)
    rows = (sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef, p)
    fwd = tdf.forward_stack(*rows)
    dtot = tdf.diag_filter_totals_plain(fwd, h, tdf.P0)
    dpre = tcf.block_prefix_plain(dtot, D, "diag_filter", False)
    dmom, _ = tdf.diag_filter_scan_plain(fwd, dpre, h, tdf.P0)
    dstot = tdf.diag_smooth_totals_plain(tdf.backward_stack(*rows), dmom)
    return {"filter": ftot, "smooth": stot, "diag_filter": dtot,
            "diag_smooth": dstot}


_JAX_ARGS = {
    "filter": (jcf._ID_VALS, jcf._unpack_elem_full, jcf._pack_elem,
               jsoa._combine2),
    "smooth": (jcf._ID_SM, jcf._unpack_sm, jcf._pack_sm,
               jks._combine2_rev),
    # as the JAX package's _diag_fwd / _diag_bwd call it
    "diag_filter": (list(jdf._ID1), tuple, list, jdf._comb1),
    "diag_smooth": (list(jdf._ID1_SM), tuple, list, jdf._comb1_rev),
}


def _jax_prefix(tot, kind, reverse, d=D):
    """The JAX `_block_prefix_pallas` (interpret mode) on (C, d * NB)
    totals. It takes NB = 128 * 2^k blocks per dim, so each dim's blocks
    are padded at the end with the identity (the prefix of a real block
    never reaches them; the suffix composes them exactly) and cut off."""
    args = _JAX_ARGS[kind]
    C, lanes = tot.shape
    nb = lanes // d
    nbp = 128
    while nbp < nb:
        nbp *= 2
    x = np.empty((C, d, nbp))
    x[:] = np.asarray(args[0], dtype=np.float64)[:, None, None]
    x[:, :, :nb] = tot.numpy().reshape(C, d, nb)
    MID = d * nbp // 128
    # lane = dd * NB + b, row-major over the (MID, 128) tile
    tiles = [jnp.asarray(c.reshape(MID, 128)) for c in x]
    out = jcf._block_prefix_pallas(tiles, *args, nbp, MID, jnp.float64,
                                   reverse=reverse, interpret=True)
    out = np.stack([np.asarray(o).reshape(d, nbp) for o in out])
    return out[:, :, :nb].reshape(C, lanes)


@pytest.mark.parametrize("kind,reverse", [("filter", False),
                                          ("smooth", True),
                                          ("diag_filter", False),
                                          ("diag_smooth", True)])
def test_block_prefix_matches_jax_pallas(totals, kind, reverse):
    tot = totals[kind]
    got = tcf.block_prefix_plain(tot, D, kind, reverse).numpy()
    ref = _jax_prefix(tot, kind, reverse)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,reverse", [("filter", False),
                                          ("smooth", True),
                                          ("diag_filter", False),
                                          ("diag_smooth", True)])
def test_block_prefix_matches_sequential_composition(totals, kind, reverse):
    """Exclusive prefix == the left-to-right (right-to-left when
    reverse) sequential composition, per dim, identity at the edge."""
    tot = totals[kind]
    got = tcf.block_prefix_plain(tot, D, kind, reverse)
    np.testing.assert_allclose(got.numpy(),
                               _sequential(tot, D, kind, reverse).numpy(),
                               rtol=0, atol=1e-12)


def _sequential(tot, d, kind, reverse):
    """The exclusive prefix (suffix) by one combine per block, per dim."""
    k = tcf.ELEMS[kind]
    C, lanes = tot.shape
    nb = lanes // d
    x = tot.reshape(C, d, nb)
    order = range(nb - 1, -1, -1) if reverse else range(nb)
    carry = k.unpack([torch.full((d,), v, dtype=tot.dtype)
                      for v in k.id_vals])
    ref = torch.empty_like(x)
    for b in order:
        ref[:, :, b] = torch.stack(k.pack(carry))
        carry = k.combine(carry, k.unpack(x[:, :, b].unbind(0)))
    return ref.reshape(C, lanes)


# ---- the CUDA kernel's tile decomposition, emulated ----


def _comb(k, a, b):
    return torch.stack(k.pack(k.combine(k.unpack(a.unbind(0)),
                                        k.unpack(b.unbind(0)))))


def _shift_in(k, x):
    """x shifted one place along the last axis, identity first."""
    ident = torch.tensor(k.id_vals, dtype=x.dtype)
    first = ident.view(-1, *([1] * (x.dim() - 1))).expand(*x.shape[:-1], 1)
    return torch.cat([first, x[..., :-1]], dim=-1)


def _inclusive(k, x):
    """Inclusive scan along the last axis (what a CUDA block computes
    over its threads; Hillis-Steele, the shifted operand first)."""
    s = 1
    while s < x.shape[-1]:
        sh = x[..., :-s]
        ident = torch.tensor(k.id_vals, dtype=x.dtype)
        fill = ident.view(-1, *([1] * (x.dim() - 1))).expand(
            *x.shape[:-1], s)
        x = _comb(k, torch.cat([fill, sh], dim=-1), x)
        s *= 2
    return x


def _tile_emulation(tot, d, kind, reverse, T):
    """csrc/block_prefix.cu in plain PyTorch. Blocks in scan order are cut
    into tiles of T, the last padded with the identity; (1) each tile's
    total; (2) the exclusive scan of each dim's tile totals, T at a time
    with a carry; (3) each block's in-tile exclusive prefix seeded with
    its tile's prefix, combine(tile prefix, in-tile prefix)."""
    k = tcf.ELEMS[kind]
    C, lanes = tot.shape
    nb = lanes // d
    ntiles = -(-nb // T)
    x = tot.reshape(C, d, nb)
    if reverse:
        x = x.flip(-1)
    ident = torch.tensor(k.id_vals, dtype=tot.dtype)
    pad = ident.view(C, 1, 1).expand(C, d, ntiles * T - nb)
    x = torch.cat([x, pad], dim=-1).reshape(C, d, ntiles, T)
    inc = _inclusive(k, x)
    tile_tot = inc[..., -1]  # (C, d, ntiles)
    carry = ident.view(C, 1).expand(C, d)
    pre = []
    for t0 in range(0, ntiles, T):
        chunk = _inclusive(k, tile_tot[..., t0:t0 + T])
        c = carry.unsqueeze(-1).expand_as(chunk)
        pre.append(_comb(k, c, _shift_in(k, chunk)))
        carry = _comb(k, carry, chunk[..., -1])
    tile_pre = torch.cat(pre, dim=-1)
    out = _comb(k, tile_pre.unsqueeze(-1).expand_as(inc), _shift_in(k, inc))
    out = out.reshape(C, d, ntiles * T)[..., :nb]
    if reverse:
        out = out.flip(-1)
    return out.reshape(C, lanes).contiguous()


def _cycled(tot, d, nb):
    """(C, d * nb) real totals: the fixture's lanes, cycled with stride 5
    so that every dim mixes blocks of both of its dims."""
    idx = torch.from_numpy((5 * np.arange(d * nb)) % tot.shape[1])
    return tot[:, idx].contiguous()


KINDS = [(kind, rev) for kind in ("filter", "smooth", "diag_filter",
                                  "diag_smooth") for rev in (False, True)]
T_KERNEL = tcf.PREFIX_TILE
TILE_NB = [1, T_KERNEL - 1, T_KERNEL, T_KERNEL + 1, 3 * T_KERNEL + 5]


@pytest.fixture(scope="module")
def jax_tile_refs(totals):
    """The JAX kernel's output for every NB of TILE_NB, per (kind,
    reverse, d): one interpret-mode call takes the five cases side by
    side as 5 * d dims, each padded to the largest NB."""
    cache = {}

    def get(kind, reverse, d, nb):
        key = (kind, reverse, d)
        if key not in cache:
            C, top = totals[kind].shape[0], max(TILE_NB)
            ident = torch.tensor(tcf.ELEMS[kind].id_vals, dtype=torch.float64)
            x = ident.view(C, 1, 1).repeat(1, len(TILE_NB) * d, top)
            for i, n in enumerate(TILE_NB):
                x[:, i * d:(i + 1) * d, :n] = _cycled(
                    totals[kind], d, n).reshape(C, d, n)
            out = _jax_prefix(x.reshape(C, -1), kind, reverse,
                              len(TILE_NB) * d).reshape(C, -1, top)
            cache[key] = {n: out[:, i * d:(i + 1) * d, :n].reshape(C, -1)
                          for i, n in enumerate(TILE_NB)}
        return cache[key][nb]

    return get


@pytest.mark.parametrize("ref", ["sequential", "jax_pallas"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("nb", TILE_NB)
@pytest.mark.parametrize("kind,reverse", KINDS)
def test_tile_emulation_matches_references(totals, jax_tile_refs, kind,
                                           reverse, nb, d, ref):
    """The kernel's tile decomposition at T = 256 against the sequential
    composition and the JAX kernel, at block counts around the tile."""
    tot = _cycled(totals[kind], d, nb)
    got = _tile_emulation(tot, d, kind, reverse, T_KERNEL).numpy()
    want = (_sequential(tot, d, kind, reverse).numpy() if ref == "sequential"
            else jax_tile_refs(kind, reverse, d, nb))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,reverse", KINDS)
def test_tile_emulation_carries_across_chunks(totals, kind, reverse):
    """A tile of 4 at NB = 3 * 4 + 5 and NB = 70: more tiles than one
    chunk of the tile-total scan, so its carry is exercised."""
    for d, nb in ((1, 17), (3, 70)):
        tot = _cycled(totals[kind], d, nb)
        got = _tile_emulation(tot, d, kind, reverse, 4)
        np.testing.assert_allclose(
            got.numpy(), _sequential(tot, d, kind, reverse).numpy(),
            rtol=0, atol=1e-12)
