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
seeded rescan; the tile size a parameter). It is held, for the four
moment-form element kinds in both directions, against the sequential
composition and against the JAX kernel at block counts that cross the
kernel's tile: NB in {1, T - 1, T, T + 1, 3T + 5} for T = 256, d in
{1, 3}, f64, atol 1e-12.

The square-root kinds (`sqrt2`: `_combine_sqrt2`, `sqrt1`:
`_combine_sqrt1`) take K2's run design. `_run_emulation` emulates its
exact schedule (runs of R blocks a thread, TH threads a tile, warps of W
lanes: run totals, the block's exclusive scan of them, the ordered
reduction of the tile totals before each tile, the seeded walk of each
run), R, TH and W parameters. Their totals are real ones: the port's
plain K8 (ops/scan_utils.py `pallas_phase1_scan_plain`) over the square-
root elements of the same record (ops/kalman_sqrt.py
`_build_sqrt_elements` / `_build_sqrt_elements1`), whose zero factors
exercise the combine's zero branches. The emulation is held, both
directions, against the sequential composition and against the JAX
package's phase 2 of these kinds (`jax.lax.associative_scan` with
`_combine_sqrt2` / `_combine_sqrt1`, then the exclusive shift, as
smoothsde_tpu/ops/scan_utils.py does) at NB in {1, R - 1, R, R + 1,
T - 1, T, T + 1, 3T + 5} for the kernel's R = 4, T = 512, d in {1, 3},
and at small geometries with more tiles than the ordered reduction
covers with one total a thread; f64, atol 1e-12 times the output's
scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.ops import ctcrw_fused as jcf
from smoothsde_tpu.ops import diag_fused as jdf
from smoothsde_tpu.ops import kalman_smooth as jks
from smoothsde_tpu.ops import kalman_soa as jsoa
from smoothsde_tpu.ops import kalman_sqrt as jsq
from smoothsde_tpu_torch.ops import ctcrw_fused as tcf
from smoothsde_tpu_torch.ops import diag_fused as tdf
from smoothsde_tpu_torch.ops import kalman_sqrt as tks
from smoothsde_tpu_torch.ops import scan_utils as tsu
from smoothsde_tpu_torch.ops.kalman_soa import _ctcrw_system, prepare_ctcrw_data

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

    def phase1_totals(kind, el):  # the plain K8's last step, per lane
        k = tcf.ELEMS[kind]
        x = torch.stack([v.expand(p.d, p.n) for v in k.pack(el)])
        st = tcf.pad_to_lanes(x, k.id_vals, p)
        return tsu.pallas_phase1_scan_plain(st, kind)[-1].contiguous()

    sys2 = _ctcrw_system(par, obs, times, ids, 0.1, 1.0, 10.0)
    return {"filter": ftot, "smooth": stot, "diag_filter": dtot,
            "diag_smooth": dstot,
            "sqrt2": phase1_totals("sqrt2", tks._build_sqrt_elements(sys2)),
            "sqrt1": phase1_totals("sqrt1",
                                   tks._build_sqrt_elements1(sysd))}


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
                                  "diag_smooth", "sqrt2", "sqrt1")
         for rev in (False, True)]
# the kinds of the tile (reduce / carry / rescan) design, and those of
# the run design
TILE_KINDS = [kr for kr in KINDS if kr[0] not in tcf.PREFIX_RUN_KINDS]
RUN_KINDS = [kr for kr in KINDS if kr[0] in tcf.PREFIX_RUN_KINDS]
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
@pytest.mark.parametrize("kind,reverse", TILE_KINDS)
def test_tile_emulation_matches_references(totals, jax_tile_refs, kind,
                                           reverse, nb, d, ref):
    """The kernel's tile decomposition at T = 256 against the sequential
    composition and the JAX kernel, at block counts around the tile."""
    tot = _cycled(totals[kind], d, nb)
    got = _tile_emulation(tot, d, kind, reverse, T_KERNEL).numpy()
    want = (_sequential(tot, d, kind, reverse).numpy() if ref == "sequential"
            else jax_tile_refs(kind, reverse, d, nb))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,reverse", TILE_KINDS)
def test_tile_emulation_carries_across_chunks(totals, kind, reverse):
    """A tile of 4 at NB = 3 * 4 + 5 and NB = 70: more tiles than one
    chunk of the tile-total scan, so its carry is exercised."""
    for d, nb in ((1, 17), (3, 70)):
        tot = _cycled(totals[kind], d, nb)
        got = _tile_emulation(tot, d, kind, reverse, 4)
        np.testing.assert_allclose(
            got.numpy(), _sequential(tot, d, kind, reverse).numpy(),
            rtol=0, atol=1e-12)


# ---- the run design (the square-root kinds), emulated ----


def _jax_phase2(x, kind):
    """The JAX package's phase 2 for the square-root kinds
    (smoothsde_tpu/ops/scan_utils.py): `jax.lax.associative_scan` of the
    (C, rows, nb) totals along the last axis, in scan order, with
    `_combine_sqrt2` / `_combine_sqrt1`, then the exclusive shift with
    the identity. Returns (C, rows, nb) numpy."""
    c = [jnp.asarray(v) for v in x]
    if kind == "sqrt2":
        el = jsq.SqrtElement2(((c[0], c[1]), (c[2], c[3])), (c[4], c[5]),
                              (c[6], c[7], c[8]), (c[9], c[10]),
                              (c[11], c[12], c[13]))
        comb = jsq._combine_sqrt2
    else:
        el, comb = jsq.SqrtElement1(*c), jsq._combine_sqrt1
    incl = jax.tree.leaves(jax.lax.associative_scan(comb, el, axis=-1))
    ident = tcf.ELEMS[kind].id_vals
    return np.stack([
        np.concatenate([np.full(v.shape[:-1] + (1,), i),
                        np.asarray(v)[..., :-1]], axis=-1)
        for v, i in zip(incl, ident)])


def _lane_shift(x, k, W, down=False):
    """__shfl_up_sync (lane i gets lane i - k) or __shfl_down_sync (lane
    i gets lane i + k) by k within each group of W lanes of the last
    axis; a lane with no source keeps its own value."""
    y = x.reshape(*x.shape[:-1], x.shape[-1] // W, W)
    if down:
        y = torch.cat([y[..., k:], y[..., W - k:]], dim=-1)
    else:
        y = torch.cat([y[..., :k], y[..., :W - k]], dim=-1)
    return y.reshape(x.shape)


def _scan_lanes(k, x, W, levels):
    """Hillis-Steele inclusive scan within groups of W lanes of the last
    axis, shifts 1, 2, ... below `levels` (csrc/block_prefix.cu
    run_block_exclusive; the shifted value is the earlier one)."""
    lane = torch.arange(x.shape[-1]) % W
    s = 1
    while s < levels:
        x = torch.where(lane >= s, _comb(k, _lane_shift(x, s, W), x), x)
        s *= 2
    return x


def _ordered_reduce(k, tt, n, TH, W):
    """csrc/block_prefix.cu ordered_reduce of the first n (C, d, n) tile
    totals: each of the first `used` threads composes its `per`
    consecutive ones, each warp its threads' in a tree, then the warps'
    totals in order."""
    per = -(-n // TH)
    used = -(-n // per)
    t = torch.arange(used)
    acc = tt[..., t * per]
    for j in range(1, per):
        idx = t * per + j
        ok = idx < n
        nxt = _comb(k, acc, tt[..., torch.where(ok, idx, 0)])
        acc = torch.where(ok, nxt, acc)
    r = None
    for w0 in range(0, used, W):
        lanes = acc[..., w0:min(w0 + W, used)]
        wn = lanes.shape[-1]
        lane = torch.arange(wn)
        s = 1
        while s < wn:
            y = _lane_shift(lanes, s, wn, down=True)
            lanes = torch.where(lane + s < wn, _comb(k, lanes, y), lanes)
            s *= 2
        r = lanes[..., 0] if r is None else _comb(k, r, lanes[..., 0])
    return r


def _run_emulation(tot, d, kind, reverse, R, TH, W=32):
    """csrc/block_prefix.cu's run design in plain PyTorch. Blocks in scan
    order are cut into tiles of TH * R (the last padded with the
    identity); thread t of a tile owns blocks t * R .. t * R + R - 1.
    Pass 1: each run's total (R - 1 combines), the tile's exclusive scan
    of them (warp scans of W lanes, then a scan of the warp totals), the
    tile total. Pass 2: each tile's prefix, the ordered reduction of the
    tile totals before it; each thread's seed combine(tile prefix, its
    exclusive prefix) (the tile prefix itself in thread 0, the exclusive
    prefix in tile 0); then the walk of its run."""
    k = tcf.ELEMS[kind]
    C, lanes = tot.shape
    nb = lanes // d
    T = TH * R
    ntiles = -(-nb // T)
    nw = TH // W
    x = tot.reshape(C, d, nb)
    if reverse:
        x = x.flip(-1)
    ident = torch.tensor(k.id_vals, dtype=tot.dtype)
    pad = ident.view(C, 1, 1).expand(C, d, ntiles * T - nb)
    x = torch.cat([x, pad], dim=-1).reshape(C, d, ntiles, TH, R)
    # pass 1
    acc = x[..., 0]
    for j in range(1, R):
        acc = _comb(k, acc, x[..., j])
    inc = _scan_lanes(k, acc, W, W)
    ex_w = _lane_shift(inc, 1, W)
    wsum = _scan_lanes(k, inc[..., W - 1::W], nw, nw)
    seed = torch.cat([ident.view(C, 1, 1, 1).expand(C, d, ntiles, 1),
                      wsum[..., :-1]], dim=-1).repeat_interleave(W, dim=-1)
    t = torch.arange(TH)
    warp0 = (t < W)
    ex = torch.where(warp0, ex_w, _comb(k, seed, ex_w))
    ex = torch.where(t % W == 0, seed, ex)
    tile_tot = wsum[..., -1]  # (C, d, ntiles)
    # pass 2
    pre = ex.clone()
    for tile in range(1, ntiles):
        sd = _ordered_reduce(k, tile_tot, tile, TH, W)  # (C, d)
        pre[:, :, tile] = torch.where(
            t == 0, sd[..., None],
            _comb(k, sd[..., None].expand(C, d, TH), ex[:, :, tile]))
    s0 = (torch.arange(ntiles)[:, None] * T + t * R)  # (ntiles, TH)
    out = torch.empty_like(x)
    for j in range(R):
        out[..., j] = pre
        if j + 1 < R:
            pre = torch.where(s0 + j + 1 < nb, _comb(k, pre, x[..., j]), pre)
    out = out.reshape(C, d, ntiles * T)[..., :nb]
    if reverse:
        out = out.flip(-1)
    return out.reshape(C, lanes).contiguous()


R_KERNEL = tcf.PREFIX_RUN
TH_KERNEL = tcf.PREFIX_RUN_THREADS
RT_KERNEL = R_KERNEL * TH_KERNEL
RUN_NB = [1, R_KERNEL - 1, R_KERNEL, R_KERNEL + 1, RT_KERNEL - 1, RT_KERNEL,
          RT_KERNEL + 1, 3 * RT_KERNEL + 5]


def _sequential_rows(k, x):
    """The exclusive prefix of (C, rows, n) totals along the last axis,
    in scan order, by one combine per block: every row at once."""
    C, rows, n = x.shape
    ident = torch.tensor(k.id_vals, dtype=x.dtype)
    carry = ident.view(C, 1).expand(C, rows)
    out = torch.empty_like(x)
    for b in range(n):
        out[..., b] = carry
        carry = _comb(k, carry, x[..., b])
    return out


@pytest.fixture(scope="module")
def run_refs(totals):
    """References for the run design's cases, per kind: for every
    (reverse, d, nb) of RUN_NB the sequential composition, the JAX
    phase 2 and the emulation at the kernel's geometry, and for
    ("plain", reverse) the JAX phase 2 of the module's totals (NB = 256,
    d = 2). The cases of a kind lie side by side as rows in scan order,
    each padded at its end with the identity, so that one sequential
    walk and one associative scan serve them all."""
    cache = {}

    def get(kind, key):
        if kind not in cache:
            k = tcf.ELEMS[kind]
            C, top = totals[kind].shape[0], max(RUN_NB)
            ident = torch.tensor(k.id_vals, dtype=torch.float64)
            cases = [(rev, d, n) for rev in (False, True) for d in (1, 3)
                     for n in RUN_NB]
            cases += [("plain", rev, D, NB) for rev in (False, True)]
            blocks, tots = [], {}
            for case in cases:
                rev, d, n = case[-3:]
                tot = totals[kind] if case[0] == "plain" else _cycled(
                    totals[kind], d, n)
                tots[case] = tot
                v = tot.reshape(C, d, n)
                v = v.flip(-1) if rev else v
                pad = ident.view(C, 1, 1).expand(C, d, top - n)
                blocks.append(torch.cat([v, pad], dim=-1))
            x = torch.cat(blocks, dim=1)
            seq = _sequential_rows(k, x)
            jx = torch.from_numpy(_jax_phase2(x.numpy(), kind))
            cache[kind] = {}
            row = 0
            for case in cases:
                rev, d, n = case[-3:]

                def back(y, row=row, d=d, n=n, rev=rev):
                    y = y[:, row:row + d, :n]
                    return (y.flip(-1) if rev else y).reshape(C, -1).numpy()

                ref = {"jax": back(jx), "sequential": back(seq)}
                if case[0] != "plain":
                    ref["emulation"] = _run_emulation(
                        tots[case], d, kind, rev, R_KERNEL,
                        TH_KERNEL).numpy()
                cache[kind][case] = ref
                row += d
        return cache[kind][key]

    return get


@pytest.mark.parametrize("kind,reverse", RUN_KINDS)
def test_block_prefix_plain_of_run_kinds_matches_jax_phase2(totals, run_refs,
                                                            kind, reverse):
    """The plain K2 of the square-root kinds against the JAX package's
    phase 2 (associative scan, exclusive shift) and against the
    sequential composition, NB = 256, d = 2, atol 1e-12 of the scale."""
    got = tcf.block_prefix_plain(totals[kind], D, kind, reverse).numpy()
    ref = run_refs(kind, ("plain", reverse, D, NB))
    scale = max(1.0, float(np.abs(ref["jax"]).max()))
    for want in (ref["jax"], ref["sequential"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("ref", ["sequential", "jax"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("nb", RUN_NB)
@pytest.mark.parametrize("kind,reverse", RUN_KINDS)
def test_run_emulation_matches_references(run_refs, kind, reverse, nb, d,
                                          ref):
    """The run design's schedule at the kernel's R = 4 and 128 threads
    (T = 512) against the sequential composition and the JAX phase 2, at
    block counts around R and T; f64, atol 1e-12 of the scale."""
    case = run_refs(kind, (reverse, d, nb))
    want = case[ref]
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(case["emulation"], want, rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("kind,reverse", RUN_KINDS)
def test_run_emulation_reduces_many_tiles(totals, kind, reverse):
    """Small geometries (R, threads, warp width) with more tiles than
    threads, so the ordered reduction of the tile totals gives a thread
    several, and with several warps: the schedule against the sequential
    composition, f64, atol 1e-12 of the scale."""
    for R, TH, W, d, nb in ((2, 4, 2, 1, 70), (3, 8, 4, 3, 203),
                            (4, 8, 2, 1, 300)):
        tot = _cycled(totals[kind], d, nb)
        got = _run_emulation(tot, d, kind, reverse, R, TH, W).numpy()
        want = _sequential(tot, d, kind, reverse).numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
