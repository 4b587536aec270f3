"""CUDA kernels of smoothsde_tpu_torch against their plain PyTorch
versions on the card: the CTCRW kernels (par-space and element-space),
the cross-block prefix K2 alone, the phase-1 scan K8, the scalar-state
(BM_SSM / OU_SSM) ones, the launcher's argument checks, the
closed-form objective on the card against the CPU, the device L-BFGS on
the card against the CPU, and the bundle's value-only log-likelihood
through the forward kernels against the forward-mode twin. Every test
that needs the card is marked `gpu` and skips without a CUDA device. This file
imports neither jax nor the JAX package, so it also runs where jax is
not installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import numpy as np
import pytest
import torch

from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.ops import diag_fused as df
from smoothsde_tpu_torch.ops import scan_utils as su
from smoothsde_tpu_torch.ops.kalman_smooth import (
    ctcrw_smoothed_states,
    llk2_analytic,
)
from smoothsde_tpu_torch.ops.kalman_soa import (
    CtcrwFusedCore,
    CtcrwPlainCore,
    _ctcrw_system,
    ctcrw_loglik_soa,
    prepare_ctcrw_data,
)


CTCRW_KERNELS = ("ctcrw_filter_totals", "block_prefix_filter",
                 "ctcrw_filter_scan", "ctcrw_smooth_totals",
                 "block_prefix_smooth", "ctcrw_score_scan")
DIAG_KERNELS = ("diag_filter_totals", "block_prefix_diag_filter",
                "diag_filter_scan", "diag_smooth_totals",
                "block_prefix_diag_smooth", "diag_score_scan")
# the kernels of llk2_analytic (value + gradient) per scan
ELEM_PATH = {
    "fused": ("elem_filter_totals", "block_prefix_filter", "elem_filter_scan",
              "elem_smooth_totals", "block_prefix_smooth", "elem_score_scan"),
    "pallas": ("phase1_scan_filter", "block_prefix_filter",
               "phase1_scan_smooth", "block_prefix_smooth"),
}


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(d, n, seed):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.05, 0.5, size=n))
    ids = (np.arange(n) >= n // 3).astype(int)
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[rng.integers(1, n, size=max(2, n // 40))] = np.nan
    par = np.column_stack([
        0.1 * rng.normal(size=(n, d)),
        np.log(2.0) + 0.3 * rng.normal(size=n),
        np.log(0.8) + 0.3 * rng.normal(size=n),
    ])
    return obs, times, ids, par


def _value_grad(core, obs, times, ids, par, dtype, device):
    data = prepare_ctcrw_data(obs, times, ids, dtype=dtype, device=device)
    p = torch.tensor(par, dtype=dtype, device=device, requires_grad=True)
    h = torch.tensor(0.04, dtype=dtype, device=device, requires_grad=True)
    v = core.apply(p, data.yd, h, data.dtv, data.resetf, data.validf,
                   1.0, 10.0)
    v.backward()
    return (v.item(), p.grad.double().cpu().numpy(), h.grad.item())


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(1, 80), (2, 5000), (3, 20000)])
def test_kernels_match_plain_f64(cuda, d, n):
    """Through the autograd.Function: value rtol 1e-10, gradient 1e-8 of
    the largest component; every kernel launched once per direction."""
    obs, times, ids, par = _data(d, n, 10 * d)
    cf.reset_launches()
    v, g, gh = _value_grad(CtcrwFusedCore, obs, times, ids, par,
                           torch.float64, cuda)
    want = {k: int(k in CTCRW_KERNELS) for k in cf.LAUNCHES}
    assert cf.LAUNCHES == want, cf.LAUNCHES
    rv, rg, rgh = _value_grad(CtcrwPlainCore, obs, times, ids, par,
                              torch.float64, cuda)
    assert cf.LAUNCHES == want, "plain path launched"
    assert v == pytest.approx(rv, rel=1e-10)
    np.testing.assert_allclose(g, rg, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(rg)))
    assert gh == pytest.approx(rgh, rel=1e-8)


@pytest.mark.gpu
def test_f32_kernels_within_accuracy_bar(cuda):
    """f32 kernels vs the f64 plain version, the docs/ACCURACY.md bar:
    value within 1e-4 relative; the gradient of the per-column
    parameters (the per-step gradients summed over steps, what a fit
    with intercept formulas sees) within 1e-4 of its largest component.
    """
    obs, times, ids, par = _data(2, 50000, 7)
    v, g, _ = _value_grad(CtcrwFusedCore, obs, times, ids, par,
                          torch.float32, cuda)
    rv, rg, _ = _value_grad(CtcrwPlainCore, obs, times, ids, par,
                            torch.float64, cuda)
    g, rg = g.sum(0), rg.sum(0)
    assert v == pytest.approx(rv, rel=1e-4)
    assert np.max(np.abs(g - rg)) <= 1e-4 * np.max(np.abs(rg))


@pytest.mark.gpu
def test_wrapper_refuses_cpu_pointer(cuda):
    """The launcher passes only CUDA tensors to a kernel."""
    from smoothsde_tpu_torch.ops import _kernels

    tot = torch.zeros((14, 8), device=cuda)
    with pytest.raises(TypeError):
        _kernels.launch("block_prefix_filter", tot, tot.cpu(), tot, 2, 4, 1,
                        0)


@pytest.mark.gpu
def test_launch_rejects_dtype_mismatch(cuda):
    """Every pointer argument is checked: a float64 output behind a
    float32 input raises instead of being read as float32."""
    from smoothsde_tpu_torch.ops import _kernels

    tot = torch.zeros((5, 8), device=cuda)
    with pytest.raises(TypeError, match="float64"):
        _kernels.launch("block_prefix_diag_filter", tot,
                        tot.to(torch.float64), tot, 2, 4, 1, 0)
    with pytest.raises(TypeError, match="contiguous"):
        _kernels.launch("block_prefix_diag_filter", tot,
                        torch.zeros((8, 5), device=cuda).T, tot, 2, 4, 1, 0)


def test_launch_checks_arguments_before_building(monkeypatch):
    """A CPU tensor handed to the launcher raises TypeError before the
    library is built or loaded (runs without a card or a toolkit)."""
    from smoothsde_tpu_torch.ops import _kernels

    def no_build():
        raise AssertionError("the launcher tried to build the kernels")

    monkeypatch.setattr(_kernels, "build", no_build)
    monkeypatch.setattr(_kernels, "_lib", None)
    tot = torch.zeros((5, 8))
    with pytest.raises(TypeError, match="CUDA"):
        _kernels.launch("block_prefix_diag_filter", tot, tot, tot, 2, 4, 1, 0)
    with pytest.raises(TypeError, match="arguments"):
        _kernels.launch("block_prefix_diag_filter", tot, tot, tot, 2, 4)


K2_KINDS = [(kind, rev) for kind in ("filter", "smooth", "diag_filter",
                                     "diag_smooth") for rev in (False, True)]
@pytest.fixture(scope="module")
def k2_totals():
    """Real per-block totals of every element kind, f64 on the card: the
    plain K1a / K3a / D1a / D3a chains over a two-track record, d = 2,
    2,048 lanes; or a skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    n = 32 * 1024
    obs, times, ids, par = _data(2, n, 60)
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device=dev)
    p = cf.plan(2, n)
    pt = torch.tensor(par, device=dev)
    stack, bd = cf.par_stack_from_data(pt, data.yd, data.dtv, data.resetf,
                                       data.validf, p)
    h = torch.tensor([0.01], dtype=torch.float64, device=dev)
    ftot = cf.filter_totals_plain(stack, bd, h, 1.0, 10.0)
    pre = cf.block_prefix_plain(ftot, 2, "filter", False)
    mom, _ = cf.filter_scan_plain(stack, bd, pre, h, 1.0, 10.0)
    sysd = df.diag_system("OU_SSM", pt, obs, times, ids, 0.1)
    rows = (sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef, p)
    fwd = df.forward_stack(*rows)
    dtot = df.diag_filter_totals_plain(fwd, h, df.P0)
    dpre = cf.block_prefix_plain(dtot, 2, "diag_filter", False)
    dmom, _ = df.diag_filter_scan_plain(fwd, dpre, h, df.P0)
    return {"filter": ftot, "smooth": cf.smooth_totals_plain(stack, mom),
            "diag_filter": dtot,
            "diag_smooth": df.diag_smooth_totals_plain(
                df.backward_stack(*rows), dmom)}


def _cycled(tot, d, nb):
    """(C, d * nb) real totals: the lanes of `tot`, cycled with stride 5."""
    idx = torch.from_numpy((5 * np.arange(d * nb)) % tot.shape[1])
    return tot[:, idx.to(tot.device)].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("nb", [1, cf.PREFIX_TILE - 1, cf.PREFIX_TILE,
                                cf.PREFIX_TILE + 1, 31250])
@pytest.mark.parametrize("kind,reverse", K2_KINDS)
def test_block_prefix_kernel_matches_plain(k2_totals, kind, reverse, nb, d):
    """K2 alone, every element kind in both directions, at block counts
    around its tile and config 5a's NB = 31,250: f64 within 1e-10 of the
    output's scale, f32 against the f64 plain version within 1e-5; one
    launch per call."""
    tot = _cycled(k2_totals[kind], d, nb)
    ref = cf.block_prefix_plain(tot, d, kind, reverse)
    scale = max(1.0, float(ref.abs().max()))
    cf.reset_launches()
    got = cf.block_prefix(tot, d, kind, reverse)
    got32 = cf.block_prefix(tot.float(), d, kind, reverse)
    assert cf.LAUNCHES[f"block_prefix_{kind}"] == 2
    assert bool(torch.isfinite(got).all()) and bool(
        torch.isfinite(got32).all())
    assert float((got - ref).abs().max()) <= 1e-10 * scale
    assert float((got32.double() - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_block_prefix_refuses_wrong_tile_count(cuda):
    """The C entry point refuses a scratch sized for another tile."""
    from smoothsde_tpu_torch.ops import _kernels

    tot = torch.zeros((5, 2 * 300), device=cuda)
    out, tiles = torch.empty_like(tot), torch.empty((5, 2 * 2), device=cuda)
    _kernels.launch("block_prefix_diag_filter", tot, out, tiles, 2, 300, 2, 0)
    with pytest.raises(RuntimeError, match="block_prefix"):
        _kernels.launch("block_prefix_diag_filter", tot, out, tiles, 2, 300,
                        1, 0)


def _diag_data(typ, d, n, seed):
    obs, times, ids, par = _data(d, n, seed)
    obs[n // 2] = np.nan  # a whole NaN row
    k = 1 if typ == "BM_SSM" else 2
    rng = np.random.default_rng(seed + 1)
    par = np.column_stack([par[:, :d]] + [
        np.log(0.7) + 0.3 * rng.normal(size=n) for _ in range(k)
    ])
    return obs, times, ids, par


def _diag_value_grad(core, typ, obs, times, ids, par, dtype, device):
    data = df.prepare_diag_data(typ, obs, times, ids, dtype=dtype,
                                device=device)
    p = torch.tensor(par, dtype=dtype, device=device, requires_grad=True)
    s = torch.tensor(0.2, dtype=dtype, device=device, requires_grad=True)
    v = df.diag_fused_loglik(
        df.diag_system(typ, p, None, None, None, s, data=data), core
    )
    v.backward()
    return (v.item(), p.grad.double().cpu().numpy(), s.grad.item())


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
@pytest.mark.parametrize("d,n", [(1, 80), (2, 5000), (3, 20001)])
def test_diag_kernels_match_plain_f64(cuda, typ, d, n):
    """BM_SSM / OU_SSM through DiagFusedCore vs DiagPlainCore: value rtol
    1e-10, gradient 1e-8 of the largest component; each diag kernel
    launched once per direction, and no CTCRW kernel."""
    obs, times, ids, par = _diag_data(typ, d, n, 10 * d + 1)
    cf.reset_launches()
    v, g, gs = _diag_value_grad(df.DiagFusedCore, typ, obs, times, ids, par,
                                torch.float64, cuda)
    want = {k: int(k in DIAG_KERNELS) for k in cf.LAUNCHES}
    assert cf.LAUNCHES == want, cf.LAUNCHES
    rv, rg, rgs = _diag_value_grad(df.DiagPlainCore, typ, obs, times, ids,
                                   par, torch.float64, cuda)
    assert cf.LAUNCHES == want, "plain path launched"
    assert v == pytest.approx(rv, rel=1e-10)
    np.testing.assert_allclose(g, rg, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(rg)))
    assert gs == pytest.approx(rgs, rel=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
def test_diag_f32_kernels_within_accuracy_bar(cuda, typ):
    """f32 kernels vs the f64 plain version: value within 1e-4 relative,
    the per-column gradient within 1e-4 of its largest component."""
    obs, times, ids, par = _diag_data(typ, 2, 50000, 17)
    v, g, _ = _diag_value_grad(df.DiagFusedCore, typ, obs, times, ids, par,
                               torch.float32, cuda)
    rv, rg, _ = _diag_value_grad(df.DiagPlainCore, typ, obs, times, ids, par,
                                 torch.float64, cuda)
    g, rg = g.sum(0), rg.sum(0)
    assert v == pytest.approx(rv, rel=1e-4)
    assert np.max(np.abs(g - rg)) <= 1e-4 * np.max(np.abs(rg))


def _flat(out):
    if isinstance(out, tuple):
        return torch.cat([o.reshape(-1) for o in out])
    return out.reshape(-1)


def _par_stack(d, n, seed, device):
    """(stack, bd, h) of the par-space path, f64 on the card, over a
    two-track record with NaN rows and irregular dt."""
    obs, times, ids, par = _data(d, n, seed)
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device=device)
    stack, bd = cf.par_stack_from_data(torch.tensor(par, device=device),
                                       data.yd, data.dtv, data.resetf,
                                       data.validf, cf.plan(d, n))
    return stack, bd, torch.tensor([0.04], dtype=torch.float64,
                                   device=device)


def _backward_inputs(d, n, L, device):
    """(stack, moments, suffix, h) of the par-space backward, f64 on the
    card, from the plain forward; cut to each lane's first L steps when L
    is given."""
    stack, bd, h = _par_stack(d, n, 70 + d, device)
    tot = cf.filter_totals_plain(stack, bd, h, 1.0, 10.0)
    pre = cf.block_prefix_plain(tot, d, "filter", False)
    mom, _ = cf.filter_scan_plain(stack, bd, pre, h, 1.0, 10.0)
    if L is not None:
        stack, mom = stack[:L].contiguous(), mom[:L].contiguous()
    suffix = cf.block_prefix_plain(cf.smooth_totals_plain(stack, mom), d,
                                   "smooth", True)
    return stack, mom, suffix, h


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("n,L", [(80, None), (2048, None), (5000, None),
                                 (20001, None), (5000, 1), (5000, 3)])
def test_backward_kernels_match_plain(cuda, d, n, L):
    """K3a and K3b alone against their plain versions: f64 within 1e-10
    of the output's scale, f32 (on the inputs rounded to f32) against the
    f64 plain version within 1e-4, the f32 bar of docs/ACCURACY.md: the
    element's 2x2 inverse and the Qinv E Qinv score on intervals down to
    dt = 0.05 cost f32 up to 4.7e-5 of the scale here, in the walk these
    kernels replaced too (the same K3a bits). Lanes below one 64-lane
    tile (n = 80: 3d lanes), at it (n = 2048: 64d) and across it, not a
    multiple of 4 (n = 5000: 157d); L around the 2-step chunk: 1 (below
    it), 3, 27, 32. One launch of each per call."""
    stack, mom, suffix, h = _backward_inputs(d, n, L, cuda)
    ref = {"K3a": cf.smooth_totals_plain(stack, mom),
           "K3b": cf.score_scan_plain(stack, mom, suffix, h, 1.0)}
    cf.reset_launches()
    errs = {}
    for dtype in (torch.float64, torch.float32):
        x = [t.to(dtype) for t in (stack, mom, suffix, h)]
        got = {"K3a": cf.smooth_totals(x[0], x[1]),
               "K3b": cf.score_scan(*x, 1.0)}
        for k, out in got.items():
            g, r = _flat(out).double(), _flat(ref[k])
            assert bool(torch.isfinite(g).all()), (k, dtype)
            scale = max(1.0, float(r.abs().max()))
            errs[(k, dtype)] = float((g - r).abs().max()) / scale
    assert cf.LAUNCHES["ctcrw_smooth_totals"] == 2
    assert cf.LAUNCHES["ctcrw_score_scan"] == 2
    bad = {k: e for k, e in errs.items()
           if e > (1e-10 if k[1] == torch.float64 else 1e-4)}
    assert not bad, errs


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("n,L", [(80, None), (2048, None), (5000, None),
                                 (20001, None), (5000, 1), (5000, 3)])
def test_forward_kernels_match_plain(cuda, d, n, L):
    """K1a and K1b alone against their plain versions: f64 within 1e-10
    of the output's scale, f32 (on the inputs rounded to f32) against the
    f64 plain version within 1e-4, the f32 bar of docs/ACCURACY.md. The
    shapes of test_backward_kernels_match_plain: lanes below, at and across
    the 128-lane CUDA block, L = 1 (no next step to prefetch) and 3; the
    prefix from the plain K1a and K2 over the (cut) stack. One launch of
    each per call."""
    stack, bd, h = _par_stack(d, n, 80 + d, cuda)
    if L is not None:
        stack = stack[:L].contiguous()
    tot = cf.filter_totals_plain(stack, bd, h, 1.0, 10.0)
    pre = cf.block_prefix_plain(tot, d, "filter", False)
    ref = {"K1a": tot,
           "K1b": cf.filter_scan_plain(stack, bd, pre, h, 1.0, 10.0)}
    cf.reset_launches()
    errs = {}
    for dtype in (torch.float64, torch.float32):
        s, b, p, hh = (t.to(dtype) for t in (stack, bd, pre, h))
        got = {"K1a": cf.filter_totals(s, b, hh, 1.0, 10.0),
               "K1b": cf.filter_scan(s, b, p, hh, 1.0, 10.0)}
        for k, out in got.items():
            g, r = _flat(out).double(), _flat(ref[k])
            assert bool(torch.isfinite(g).all()), (k, dtype)
            scale = max(1.0, float(r.abs().max()))
            errs[(k, dtype)] = float((g - r).abs().max()) / scale
    assert cf.LAUNCHES["ctcrw_filter_totals"] == 2
    assert cf.LAUNCHES["ctcrw_filter_scan"] == 2
    bad = {k: e for k, e in errs.items()
           if e > (1e-10 if k[1] == torch.float64 else 1e-4)}
    assert not bad, errs


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["BM_SSM", "OU_SSM"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("n,L", [(80, None), (2048, None), (5000, None),
                                 (20001, None), (5000, 1), (5000, 3),
                                 (5000, 5), (5000, 8), (5000, 16),
                                 (5000, 24), (5000, 27)])
def test_diag_kernels_alone_match_plain(cuda, typ, d, n, L):
    """D1a, D1b, D3a and D3b alone against their plain versions, with the
    inputs and calls of chip_smoke.py's phase 2e: f64 within 1e-10 of the
    output's scale, f32 (on the inputs rounded to f32) against the f64
    plain version within 1e-4. Lanes below, at and across the 32-lane
    CUDA blocks of D1a, D1b and D3a and D3b's 128-lane one, not a multiple
    of 4 (n = 5000: 157 d lanes); L = 1 (three of the four segments empty,
    no next step to load ahead), 3, 5 and 27 (the last segments short: 2,
    2, 1, 0 and 7, 7, 7, 6 steps), 8, 16 and 24 (L = 32's segment
    boundaries: chip_smoke.D_CUTS). One launch of each per call, and one
    more of D1a for D1b's seeds."""
    from chip_smoke import D_ALONE as calls
    from chip_smoke import diag_inputs

    x64 = diag_inputs(torch, d, n, L, typ)
    ref = {k: call(df.OPS["plain"], x64) for k, call in calls.items()}
    cf.reset_launches()
    errs = {}
    for dtype in (torch.float64, torch.float32):
        x = [t.to(dtype) for t in x64]
        for k, call in calls.items():
            g, r = _flat(call(df.OPS["kernels"], x)).double(), _flat(ref[k])
            assert bool(torch.isfinite(g).all()), (k, dtype)
            scale = max(1.0, float(r.abs().max()))
            errs[(k, dtype)] = float((g - r).abs().max()) / scale
    want = {k: 4 if k == "diag_filter_totals" else 2 for k in calls}
    assert {k: cf.LAUNCHES[k] for k in calls} == want, cf.LAUNCHES
    bad = {k: e for k, e in errs.items()
           if e > (1e-10 if k[1] == torch.float64 else 1e-4)}
    assert not bad, errs


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(1, 80), (2, 5000), (3, 20001)])
def test_elem_and_phase1_kernels_match_plain_f64(cuda, d, n):
    """K4a, K4b, K5a, K5b and K8 (filtering and smoothing elements, both
    directions) each against its plain version on the card, f64: max abs
    error within 1e-12 of the output's scale, 1e-7 for K5b, whose score
    rows carry Qinv E Qinv (the JAX package's form): roundoff in E, a
    difference of covariance terms, grows by 1/q^2 where a short interval
    makes Q small (dt down to 0.05 here; 1.2e-8 measured on an H100)."""
    obs, times, ids, par = _data(d, n, 30 + d)
    sys = _ctcrw_system(torch.tensor(par, device=cuda), obs, times, ids, 0.2)
    p = cf.plan(d, n)
    fst, bst = cf.elem_forward_stack(sys, p), cf.elem_backward_stack(sys, p)
    h1 = sys.h.reshape(1)
    ops_k, ops_p = cf.ELEM_OPS["kernels"], cf.ELEM_OPS["plain"]
    tot = ops_k.filter_totals(fst, h1, 1.0, 10.0)
    pre = ops_k.block_prefix(tot, d, "filter", False)
    mom, _ = ops_k.filter_scan(fst, pre, h1, 1.0, 10.0)
    stot = ops_k.smooth_totals(bst, mom)
    suf = ops_k.block_prefix(stot, d, "smooth", True)
    rng = np.random.default_rng(d)
    sm = torch.tensor(rng.normal(scale=0.5, size=(p.L, 9, p.lanes)),
                      device=cuda)
    el = cf.pad_to_lanes(torch.stack(cf._pack_elem(sys.elem)),
                         cf._ID_VALS, p)
    calls = {
        "K4a": lambda o: o.filter_totals(fst, h1, 1.0, 10.0),
        "K4b": lambda o: o.filter_scan(fst, pre, h1, 1.0, 10.0),
        "K5a": lambda o: o.smooth_totals(bst, mom),
        "K5b": lambda o: o.score_scan(bst, mom, suf, h1, 1.0),
    }
    pairs = [(k, fn(ops_k), fn(ops_p)) for k, fn in calls.items()]
    for elem, x in (("filter", el), ("smooth", sm)):
        for rev in (False, True):
            pairs.append((f"K8 {elem} reverse={rev}",
                          su.pallas_phase1_scan(x, elem, rev),
                          su.pallas_phase1_scan_plain(x, elem, rev)))
    errs = {}
    for name, got, ref in pairs:
        got, ref = _flat(got), _flat(ref)
        assert bool(torch.isfinite(got).all()), name
        scale = max(1.0, float(ref.abs().max()))
        errs[name] = float((got - ref).abs().max()) / scale
    bad = {k: e for k, e in errs.items()
           if e > (1e-7 if k == "K5b" else 1e-12)}
    assert not bad, errs


@pytest.mark.gpu
@pytest.mark.parametrize("scan", ["fused", "pallas"])
@pytest.mark.parametrize("d,n", [(1, 80), (2, 5000), (3, 20001)])
def test_llk2_analytic_matches_par_space_f64(cuda, d, n, scan):
    """llk2_analytic through the element-space kernels (value + gradient
    in par and sigma_obs) against the par-space plain core, f64: value
    rtol 1e-10, gradient 1e-8 of the largest component; each kernel of
    the path launched once, and no other."""
    obs, times, ids, par = _data(d, n, 40 + d)
    p = torch.tensor(par, device=cuda, requires_grad=True)
    s = torch.tensor(0.2, dtype=torch.float64, device=cuda,
                     requires_grad=True)
    cf.reset_launches()
    v = llk2_analytic(_ctcrw_system(p, obs, times, ids, s), scan)
    v.backward()
    want = {k: int(k in ELEM_PATH[scan]) for k in cf.LAUNCHES}
    assert cf.LAUNCHES == want, cf.LAUNCHES
    rv, rg, rgh = _value_grad(CtcrwPlainCore, obs, times, ids, par,
                              torch.float64, cuda)
    g = p.grad.cpu().numpy()
    # d/d sigma_obs = 2 sigma_obs d/dh
    assert v.item() == pytest.approx(rv, rel=1e-10)
    np.testing.assert_allclose(g, rg, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(rg)))
    assert s.grad.item() == pytest.approx(2 * 0.2 * rgh, rel=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("scan", ["fused", "pallas"])
def test_llk2_analytic_f32_within_accuracy_bar(cuda, scan):
    """f32 kernels vs the f64 plain version: value within 1e-4 relative,
    the per-column gradient within 1e-4 of its largest component."""
    obs, times, ids, par = _data(2, 50000, 9)
    p = torch.tensor(par, dtype=torch.float32, device=cuda,
                     requires_grad=True)
    v = llk2_analytic(_ctcrw_system(p, obs, times, ids, 0.2), scan)
    v.backward()
    rv, rg, _ = _value_grad(CtcrwPlainCore, obs, times, ids, par,
                            torch.float64, cuda)
    g, rg = p.grad.double().cpu().numpy().sum(0), rg.sum(0)
    assert v.item() == pytest.approx(rv, rel=1e-4)
    assert np.max(np.abs(g - rg)) <= 1e-4 * np.max(np.abs(rg))


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(1, 80), (2, 5000)])
def test_smoothed_states_kernels_match_plain_f64(cuda, d, n):
    """scan="auto" on the card runs K8 (both element types) and K2; it
    agrees with the plain Hillis-Steele scan to 1e-10 of the scale."""
    obs, times, ids, par = _data(d, n, 50 + d)
    pt = torch.tensor(par, device=cuda)
    cf.reset_launches()
    got = ctcrw_smoothed_states(pt, obs, times, ids, 0.2)
    want = {k: int(k in ELEM_PATH["pallas"]) for k in cf.LAUNCHES}
    assert cf.LAUNCHES == want, cf.LAUNCHES
    ref = ctcrw_smoothed_states(pt, obs, times, ids, 0.2, scan="associative")
    for a, b in zip(got, ref):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-10 * scale


@pytest.mark.gpu
def test_kernels_refuse_autograd(cuda):
    """The kernels are forward-only: an autograd path through a launch
    raises instead of returning a gradient-less value."""
    obs, times, ids, par = _data(1, 200, 3)
    p = torch.tensor(par, device=cuda, requires_grad=True)
    for scan in ("fused", "pallas"):
        with pytest.raises(RuntimeError, match="forward-only"):
            ctcrw_loglik_soa(p, obs, times, ids, 0.2, scan=scan)


def _closed_form_case(typ):
    """SDE keyword arguments of a small closed-form model; OU carries a
    smooth on mu (the Laplace approximation), BM_t its df."""
    rng = np.random.default_rng(60)
    n = 400
    dt = rng.uniform(0.2, 0.6, size=n - 1)
    times = np.concatenate([[0.0], np.cumsum(dt)])
    if typ == "CIR":
        z = 2.0 + np.cumsum(rng.normal(size=n) * 0.05)
    else:
        z = np.cumsum(rng.normal(size=n) * 0.3)
    data = {"ID": (np.arange(n) >= 150).astype(int), "time": times, "z": z}
    kw = {"data": data, "type": typ, "response": "z"}
    if typ == "BM_t":
        kw["other_data"] = {"df": 5.0}
    if typ == "OU":
        kw["formulas"] = {"mu": "~s(time, k=5, bs='cs')", "tau": "~1",
                          "kappa": "~1"}
    return kw


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["BM", "BM_t", "OU", "CIR"])
def test_closed_form_on_card_matches_cpu_f64(cuda, typ):
    """The closed-form objective (plain torch ops, no kernel) on the card
    against the same model on the CPU, f64, at the start point: the
    Laplace marginal (joint nllk without inner coefficients) to 1e-10
    relative, its gradient and bhat to 1e-8 of their scale; the model's
    tensors stay on the card."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad

    kw = _closed_form_case(typ)
    gpu = SDE(**kw, device="cuda", dtype=torch.float64).bundle()
    cpu = SDE(**kw, device="cpu", dtype=torch.float64).bundle()
    x = gpu.packer.outer_init()
    full = gpu.packer.unpack(torch.tensor(x, device=cuda))
    assert all(v.is_cuda for v in full.values())
    assert gpu.par_matrix(full).is_cuda
    v, g, b = make_val_grad(gpu)(x)
    rv, rg, rb = make_val_grad(cpu)(x)
    assert np.isfinite(v) and v == pytest.approx(rv, rel=1e-10)
    np.testing.assert_allclose(g, rg, rtol=0,
                               atol=1e-8 * max(1.0, np.max(np.abs(rg))))
    assert len(b) == gpu.packer.n_inner == (4 if typ == "OU" else 0)
    np.testing.assert_allclose(b, rb, rtol=0, atol=1e-8)


@pytest.mark.gpu
def test_config4_marginal_f32_matches_f64(cuda):
    """Config 4 (8 x 250-step CTCRW, tau ~ s(ID, bs='re')) on the card:
    the Laplace marginal (value term on K1-K3, the second-order terms on
    the forward-mode twin) in f32 within 1e-4 relative of f64's at the
    start point, its gradient within 1e-4 of |nllk|, and a marginal
    evaluation launches every CTCRW kernel."""
    import chip_smoke
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad

    kw, _ = chip_smoke.config4()
    out = {}
    for dtype in (torch.float32, torch.float64):
        bundle = SDE(**kw, device="cuda", dtype=dtype).bundle()
        cf.reset_launches()
        out[dtype] = make_val_grad(bundle)(bundle.packer.outer_init())
        for name in CTCRW_KERNELS:
            assert cf.LAUNCHES[name] > 0, name
    (v32, g32, b32), (v64, g64, b64) = out[torch.float32], out[torch.float64]
    assert abs(v32 - v64) <= 1e-4 * abs(v64)
    assert np.max(np.abs(g32 - g64)) <= 1e-4 * abs(v64)
    assert np.all(np.isfinite(b32)) and len(b32) == len(b64) == 8


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["CTCRW", "OU_SSM", "BM_SSM"])
def test_twin_matches_kernels_200k(cuda, typ):
    """The forward-mode twin's long branch (the SoA filter's plain
    "blocked" scan) against the kernel route at n = 200,000 on two
    tracks, f64: value within 1e-10 relative, gradient within 1e-8 of
    its largest component; the twin launches no kernel."""
    from smoothsde_tpu_torch import SDE

    obs, times, ids, _ = _data(2, 200_000, 11)
    data = {"ID": ids, "time": times, "y1": obs[:, 0], "y2": obs[:, 1]}
    par0 = {"CTCRW": [0.0, 0.0, 2.0, 0.8], "OU_SSM": [0.0, 0.0, 1.0, 1.0],
            "BM_SSM": [0.0, 0.0, 0.5]}[typ]
    bundle = SDE(data=data, type=typ, response=["y1", "y2"], par0=par0,
                 device="cuda", dtype=torch.float64).bundle()
    assert bundle.twin == "blocked"

    def value_grad(fn):
        x = torch.tensor(bundle.packer.outer_init(), device=cuda,
                         requires_grad=True)
        v = fn(bundle.packer.unpack(x))
        (g,) = torch.autograd.grad(v, x)
        return float(v.detach()), g.cpu().numpy()

    cf.reset_launches()
    tv, tg = value_grad(bundle.joint_nllk_ad)
    assert not any(cf.LAUNCHES.values())
    kv, kg = value_grad(bundle.joint_nllk)
    assert tv == pytest.approx(kv, rel=1e-10)
    np.testing.assert_allclose(tg, kg, rtol=0,
                               atol=1e-8 * np.max(np.abs(kg)))


@pytest.mark.gpu
def test_device_lbfgs_on_card_matches_cpu(cuda):
    """The L-BFGS with its state on the device at config 1's shape (BM,
    n = 1,000, f64, no inner coefficients): on the card, each step a
    CUDA graph, against the same run on the CPU: x within 1e-8, f within
    1e-12 relative, the same iterations and evaluations."""
    import chip_smoke
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad
    from smoothsde_tpu_torch.infer.lbfgs import device_lbfgs

    kw, _ = chip_smoke.config1()
    out = {}
    for device in ("cuda", "cpu"):
        bundle = SDE(**kw, device=device, dtype=torch.float64).bundle()
        make_val_grad(bundle)  # the bundle's marginal
        x0 = torch.tensor(bundle.packer.outer_init(), device=device)
        out[device] = device_lbfgs(bundle.marginal, x0, x0.new_zeros(0))
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.graph == "graph" and cpu.graph == "eager"
    assert bool(gpu.converged) and bool(cpu.converged)
    np.testing.assert_allclose(gpu.x.cpu().numpy(), cpu.x.numpy(), rtol=0,
                               atol=1e-8)
    assert float(gpu.f) == pytest.approx(float(cpu.f), rel=1e-12)
    assert int(gpu.n_iter) == int(cpu.n_iter)
    assert int(gpu.n_evals) == int(cpu.n_evals)
    assert gpu.steps == int(gpu.n_evals) - 1


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["CTCRW", "OU_SSM", "BM_SSM"])
def test_loglik_through_kernels_matches_twin(cuda, typ):
    """`bundle.loglik` (what `SDE.log_lik` reads) on the card is a
    value-only pass through the forward kernels (K1a, K2, K1b for CTCRW
    at config 4 with its random effect; D1a, K2, D1b for the diagonal
    models at 20,001 steps) and equals -joint_nllk_unpenalized through
    the forward-mode twin to 1e-10 relative, f64."""
    import chip_smoke
    from smoothsde_tpu_torch import SDE

    if typ == "CTCRW":
        kw, _ = chip_smoke.config4()
        forward = ("ctcrw_filter_totals", "block_prefix_filter",
                   "ctcrw_filter_scan")
    else:
        obs, times, ids, _ = _diag_data(typ, 2, 20001, 12)
        kw = dict(data={"ID": ids, "time": times, "y1": obs[:, 0],
                        "y2": obs[:, 1]}, type=typ, response=["y1", "y2"])
        forward = ("diag_filter_totals", "block_prefix_diag_filter",
                   "diag_filter_scan")
    bundle = SDE(**kw, device="cuda", dtype=torch.float64).bundle()
    rng = np.random.default_rng(3)
    outer = torch.tensor(bundle.packer.outer_init(), device=cuda)
    inner = torch.tensor(0.1 * rng.normal(size=bundle.packer.n_inner),
                         device=cuda)
    full = bundle.packer.unpack(outer, inner)
    cf.reset_launches()
    with torch.no_grad():
        v = float(bundle.loglik(full))
    assert [cf.LAUNCHES[k] for k in forward] == [1, 1, 1]
    assert sum(cf.LAUNCHES.values()) == 3  # no backward kernel
    with torch.no_grad():
        twin = -float(bundle.joint_nllk_unpenalized(full))
    assert v == pytest.approx(twin, rel=1e-10)


@pytest.mark.gpu
def test_laplace_log_det_partials_do_not_follow_history(cuda):
    """The Laplace layer's cross derivatives and log-det partials
    (`tail`, taken by jacfwd) at config 4 on the card: in f32 the same
    bits on every call, before and after reverse-mode passes over the
    inner Hessian (which the autograd engine orders by per-thread
    sequence numbers); in f64 equal to those reverse-mode partials to
    1e-10 of the largest."""
    import chip_smoke
    from torch.func import grad

    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad
    from smoothsde_tpu_torch.twin_bench import X_OPT

    kw, _ = chip_smoke.config4()
    for dtype in (torch.float32, torch.float64):
        bundle = SDE(**kw, device="cuda", dtype=dtype).bundle()
        make_val_grad(bundle)
        graphs = bundle.marginal.graphs
        tail, hess = graphs["tail"].fn, graphs["hess"].fn
        x = torch.tensor(X_OPT, dtype=dtype, device=cuda)
        b = torch.full((bundle.packer.n_inner,), 0.1, dtype=dtype,
                       device=cuda)
        W = torch.linalg.inv(hess(x, b))

        def reverse():
            return grad(lambda o, bb: (0.5 * W * hess(o, bb)).sum(),
                        argnums=(0, 1))(x, b)

        first = tail(x, b, W)
        rev = reverse()
        again = tail(x, b, W)
        for a, c in zip(first, again):
            assert torch.equal(a, c)
        if dtype == torch.float64:
            for a, r in zip(first[1:], rev):
                scale = float(r.abs().max())
                assert float((a - r).abs().max()) <= 1e-10 * scale


# the phase-1 kinds of the generic and special filters: the scalar-state
# elements and the square-root ones
SLICE_K8 = ("diag_filter", "diag_smooth", "sqrt2", "sqrt1")


def _slice_stacks(d, n, seed, cuda):
    """Real (L, C, lanes) stacks of the four kinds over _data(d, n),
    f64 on the card (chip_smoke.slice_elements)."""
    import chip_smoke

    obs, times, ids, par = _data(d, n, seed)
    pt = torch.tensor(par, device=cuda)
    els = {**chip_smoke.slice_elements(torch, "CTCRW", pt, 0.2, obs, times,
                                       ids),
           **chip_smoke.slice_elements(torch, "OU_SSM", pt, 0.2, obs, times,
                                       ids)}
    p = cf.plan(d, n)
    return {k: chip_smoke.elem_stack(torch, k, els[k], p) for k in SLICE_K8}


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(1, 80), (1, 4064), (1, 4096), (1, 4128),
                                 (2, 5000), (3, 20001)])
def test_phase1_and_prefix_for_slice_kinds_match_plain(cuda, d, n):
    """K8 for the scalar-state and square-root kinds and K2 for `sqrt2` /
    `sqrt1`, both directions, lanes below, at and across K8's 128-thread
    CUDA block: f64 within 1e-10 of the output's scale, f32 (against the
    f64 plain version) within 1e-4 (K8) and 1e-5 (K2)."""
    stacks = _slice_stacks(d, n, 80 + d, cuda)
    errs = {}
    for kind, st in stacks.items():
        for rev in (False, True):
            ref = su.pallas_phase1_scan_plain(st, kind, rev)
            pairs = [(f"K8 {kind} {rev}", su.pallas_phase1_scan(st, kind, rev),
                      su.pallas_phase1_scan(st.float(), kind, rev), ref, 1e-4)]
            if kind in ("sqrt2", "sqrt1"):
                tot = ref[-1].contiguous()
                pairs.append((f"K2 {kind} {rev}",
                              cf.block_prefix(tot, d, kind, rev),
                              cf.block_prefix(tot.float(), d, kind, rev),
                              cf.block_prefix_plain(tot, d, kind, rev), 1e-5))
            for name, g64, g32, r, bar32 in pairs:
                assert bool(torch.isfinite(g64).all()), name
                assert bool(torch.isfinite(g32).all()), name
                scale = max(1.0, float(r.abs().max()))
                e64 = float((g64 - r).abs().max()) / scale
                e32 = float((g32.double() - r).abs().max()) / scale
                errs[name] = (e64, e32)
                assert e64 <= 1e-10 and e32 <= bar32, (name, e64, e32)


def _run_design_cases():
    """(d, NB) around K2's run design's geometry (R blocks a thread, T =
    R x threads blocks a tile): below, at and across R and T, three
    tiles and a ragged end, more tiles than one CUDA block's ordered
    reduction of the tile totals covers with one total a thread, and
    config 5a's NB = 31,250 at d = 2."""
    R = cf.PREFIX_RUN
    T = R * cf.PREFIX_RUN_THREADS
    return [(1, 1), (1, R - 1), (1, R), (1, R + 1), (2, T - 1), (2, T),
            (2, T + 1), (3, 3 * T + 5),
            (1, T * (cf.PREFIX_RUN_THREADS + 2) + 7), (2, 31_250)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sqrt2", "sqrt1"])
def test_block_prefix_run_design_matches_plain(cuda, kind):
    """K2 `sqrt2` / `sqrt1` (the run design), both directions, on real
    square-root totals at _run_design_cases' block counts, with some
    blocks set to the identity (padding) and some with exact zero U or Z
    factors (a NaN row's): finite, f64 within 1e-10 of the output's
    scale, f32 against the f64 plain version within 1e-5; two calls on
    the same input give the same bits; one launch a call."""
    st = _slice_stacks(2, 32 * 1024, 77, cuda)[kind]
    base = su.pallas_phase1_scan_plain(st, kind)[-1].contiguous()
    k = cf.ELEMS[kind]
    ident = torch.tensor(k.id_vals, dtype=torch.float64, device=cuda)
    # U and Z (u and z for sqrt1): the factors a NaN row leaves at zero
    u_rows, z_rows = ((6, 7, 8), (11, 12, 13)) if kind == "sqrt2" else \
        ((2,), (4,))
    for d, nb in _run_design_cases():
        tot = _cycled(base, d, nb)
        cols = torch.arange(tot.shape[1], device=cuda)
        tot[:, cols % 11 == 3] = ident[:, None]
        for r in u_rows:
            tot[r, cols % 13 == 5] = 0.0
        for r in z_rows:
            tot[r, cols % 17 == 9] = 0.0
        for rev in (False, True):
            ref = cf.block_prefix_plain(tot, d, kind, rev)
            scale = max(1.0, float(ref.abs().max()))
            cf.reset_launches()
            got = cf.block_prefix(tot, d, kind, rev)
            assert cf.LAUNCHES[f"block_prefix_{kind}"] == 1
            again = cf.block_prefix(tot, d, kind, rev)
            got32 = cf.block_prefix(tot.float(), d, kind, rev)
            again32 = cf.block_prefix(tot.float(), d, kind, rev)
            where = (kind, d, nb, rev)
            assert bool(torch.isfinite(got).all()), where
            assert bool(torch.isfinite(got32).all()), where
            assert torch.equal(got, again) and torch.equal(got32, again32), \
                where
            e64 = float((got - ref).abs().max()) / scale
            e32 = float((got32.double() - ref).abs().max()) / scale
            assert e64 <= 1e-10 and e32 <= 1e-5, (where, e64, e32)


@pytest.mark.gpu
def test_block_prefix_kernels_by_element_type(cuda):
    """The moment-form K2 instantiations launch the tile design's three
    kernels (reduce, carry, rescan); the square-root ones the run
    design's two (runs, runs rescan); each call one of each (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    want = {
        "filter": ("Elem14", ("block_prefix_reduce_kernel",
                              "block_prefix_carry_kernel",
                              "block_prefix_rescan_kernel")),
        "smooth": ("Smooth9", ("block_prefix_reduce_kernel",
                               "block_prefix_carry_kernel",
                               "block_prefix_rescan_kernel")),
        "diag_filter": ("Elem5", ("block_prefix_reduce_kernel",
                                  "block_prefix_carry_kernel",
                                  "block_prefix_rescan_kernel")),
        "diag_smooth": ("Smooth3", ("block_prefix_reduce_kernel",
                                    "block_prefix_carry_kernel",
                                    "block_prefix_rescan_kernel")),
        "sqrt2": ("Sqrt14", ("block_prefix_runs_kernel",
                             "block_prefix_runs_rescan_kernel")),
        "sqrt1": ("Sqrt5", ("block_prefix_runs_kernel",
                            "block_prefix_runs_rescan_kernel")),
    }
    for kind, (elem, names) in want.items():
        ident = torch.tensor(cf.ELEMS[kind].id_vals, device=cuda)
        tot = ident[:, None].repeat(1, 2 * 3000).contiguous()
        cf.block_prefix(tot, 2, kind, False)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cf.block_prefix(tot, 2, kind, False)
            torch.cuda.synchronize()
        got = sorted(e.key.split("ssde::")[1].split("<")[0]
                     for e in prof.key_averages()
                     if "block_prefix" in e.key and elem in e.key
                     for _ in range(e.count))
        assert got == sorted(names), (kind, got)


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["ctcrw_sqrt", "ou_sqrt", "ou_soa"])
def test_pallas_scans_of_slice_kinds_match_blocked(cuda, fn):
    """`ctcrw_loglik_sqrt`, `diag_ssm_loglik_sqrt` and
    `diag_ssm_loglik_soa` with scan="pallas" (K8 and K2 of their kinds,
    each launched once) against "blocked", f64, 1e-10 relative; a
    gradient through "pallas" raises (the kernels are forward-only)."""
    from smoothsde_tpu_torch.ops.kalman_soa import diag_ssm_loglik_soa
    from smoothsde_tpu_torch.ops.kalman_sqrt import (
        ctcrw_loglik_sqrt,
        diag_ssm_loglik_sqrt,
    )

    obs, times, ids, par = _data(2, 50000, 21)
    call = {
        "ctcrw_sqrt": (lambda p, s: ctcrw_loglik_sqrt(p, obs, times, ids, 0.2,
                                                      scan=s),
                       ("phase1_scan_sqrt2", "block_prefix_sqrt2")),
        "ou_sqrt": (lambda p, s: diag_ssm_loglik_sqrt(
            "OU_SSM", p, obs, times, ids, 0.2, scan=s),
            ("phase1_scan_sqrt1", "block_prefix_sqrt1")),
        "ou_soa": (lambda p, s: diag_ssm_loglik_soa(
            "OU_SSM", p, obs, times, ids, 0.2, scan=s),
            ("phase1_scan_diag_filter", "block_prefix_diag_filter")),
    }
    f, path = call[fn]
    p = torch.tensor(par, device=cuda)
    want = float(f(p, "blocked"))
    cf.reset_launches()
    got = float(f(p, "pallas"))
    assert got == pytest.approx(want, rel=1e-10)
    assert {k: v for k, v in cf.LAUNCHES.items() if v} == \
        {k: 1 for k in path}
    with pytest.raises(RuntimeError, match="forward-only"):
        f(p.clone().requires_grad_(True), "pallas")


@pytest.mark.gpu
@pytest.mark.parametrize("other", ["H", "P0", "eseal"])
def test_generic_route_on_card_matches_cpu(cuda, other):
    """The generic route (user H, user P0, ESEAL_SSM) on the card (the
    parallel full-state filter, "auto") against the same model on the
    CPU (the sequential filter), f64, at the start point: the joint nllk
    to 1e-10 relative and its gradient to 1e-8 of the largest component;
    the filtered states (1e-10 of the largest) and the innovations
    (1e-8) read off the parallel filter's moments."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad

    obs, times, ids, _ = _data(2, 3000, 31)
    rng = np.random.default_rng(4)
    if other == "eseal":
        n = len(ids)
        kw = dict(data={"ID": ids, "time": np.arange(n, dtype=float),
                        "z": -0.5 + 0.01 * np.cumsum(rng.normal(size=n))},
                  type="ESEAL_SSM", response="z", par0=[0.0, 0.3],
                  other_data={"h": rng.uniform(80, 120, size=n),
                              "R": rng.uniform(9, 11, size=n),
                              "dep_fat": np.full(n, 60.0)})
    else:
        H = np.einsum("ni,ij->nij", rng.uniform(0.01, 0.05, size=(len(ids),
                                                                  2)),
                      np.eye(2))
        kw = dict(data={"ID": ids, "time": times, "y1": obs[:, 0],
                        "y2": obs[:, 1]}, type="CTCRW",
                  response=["y1", "y2"], par0=[0.0, 0.0, 2.0, 0.8],
                  other_data={"H": H} if other == "H" else
                  {"P0": np.diag([1.0, 5.0, 2.0, 8.0])})
    gpu = SDE(**kw, device="cuda", dtype=torch.float64).bundle()
    cpu = SDE(**kw, device="cpu", dtype=torch.float64).bundle()
    assert (gpu.twin, cpu.twin) == ("parallel", "sequential")
    x = gpu.packer.outer_init()
    v, g, _ = make_val_grad(gpu)(x)
    rv, rg, _ = make_val_grad(cpu)(x)
    assert v == pytest.approx(rv, rel=1e-10)
    np.testing.assert_allclose(g, rg, rtol=0, atol=1e-8 * np.abs(rg).max())
    with torch.no_grad():
        fg = gpu.packer.unpack(torch.tensor(x, device=cuda))
        fc = cpu.packer.unpack(torch.tensor(x))
        s, rs = gpu.filter_states(fg).cpu(), cpu.filter_states(fc)
        assert float((s - rs).abs().max()) <= 1e-10 * float(rs.abs().max())
        for a, b in zip(gpu.innovations(fg), cpu.innovations(fc)):
            a = a.cpu()
            if a.dtype == torch.bool:
                assert torch.equal(a, b)
            else:
                assert float((a - b).abs().max()) <= 1e-8 * max(
                    1.0, float(b.abs().max()))


def _edge_data(seed=3, n=700):
    """The chunk-edge geometry of tests/test_torch_dist.py: a track
    boundary on the first slot of 8-way chunk 3 (slot 264), another
    inside it, a NaN row."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.4, 0.6, size=n))
    obs = np.cumsum(rng.normal(size=(n, 2)) * 0.3, axis=0)
    obs[50, :] = np.nan
    ids = np.concatenate([np.zeros(264, int), np.full(36, 1), np.full(400, 2)])
    return obs, times, ids


EDGE_THETA = {"CTCRW": [0.1, -0.2, np.log(2.0), 0.0],
              "BM_SSM": [0.1, -0.2, np.log(0.8)],
              "OU_SSM": [0.1, -0.2, np.log(2.0), np.log(0.6)]}


def _time_sharded_routes(cuda, typ, shards):
    """The edge data's time-sharded likelihood on `shards` chunks of the
    card through the kernels and through the plain op tables, and the
    unsharded kernel route, f64."""
    from smoothsde_tpu_torch.models.registry import get_model_spec
    from smoothsde_tpu_torch.parallel import dist
    from smoothsde_tpu_torch.parallel.batching import make_mesh

    obs, times, ids = _edge_data()
    spec = get_model_spec(typ, 2)
    mesh = make_mesh(shards, "time", device="cuda:0")
    kern = dist.build_time_sharded_loglik(spec, obs, times, ids, mesh,
                                          "time", dtype=torch.float64,
                                          device=cuda).loglik
    flat = dist.build_sharded_loglik(spec, obs, times, ids,
                                     make_mesh(1, device="cuda:0"),
                                     dtype=torch.float64).loglik
    build = (dist._build_time_sharded_fused_ctcrw if typ == "CTCRW"
             else dist._build_time_sharded_fused_diag)
    plain = build(spec, obs, times, ids, mesh, "time", dtype=torch.float64,
                  ops_name="plain")
    return kern, plain, flat


def _edge_full(cuda):
    return {"log_sigma_obs": torch.tensor([np.log(0.1)], dtype=torch.float64,
                                          device=cuda)}


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["CTCRW", "BM_SSM", "OU_SSM"])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_stitched_kernels_match_plain(cuda, typ, shards):
    """The time-sharded kernel cores (K1a / K2 / K1b and K3a / K2 / K3b
    stitched across chunks; D1a-D3b for the scalar-state types) on
    `shards` chunks of the card against the same cores on the plain op
    tables, f64: value within 1e-10 relative, gradient within 1e-8 of its
    largest component, each kernel launched once a chunk; and against
    the unsharded kernel route at 1e-10 / 1e-8."""
    kern, plain, flat = _time_sharded_routes(cuda, typ, shards)
    n = len(_edge_data()[2])
    theta = EDGE_THETA[typ]

    def vg(fn):
        th = torch.tensor(theta, dtype=torch.float64, device=cuda,
                          requires_grad=True)
        v = fn(_edge_full(cuda), th.expand(n, len(theta)))
        (g,) = torch.autograd.grad(v, th)
        return v.item(), g.cpu().numpy()

    names = CTCRW_KERNELS if typ == "CTCRW" else DIAG_KERNELS
    cf.reset_launches()
    v, g = vg(kern)
    for name in names:
        assert cf.LAUNCHES[name] == shards, (name, cf.LAUNCHES[name])
    for ref in (plain, flat):
        rv, rg = vg(ref)
        assert v == pytest.approx(rv, rel=1e-10)
        assert np.max(np.abs(g - rg)) <= 1e-8 * np.max(np.abs(rg))


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["CTCRW", "BM_SSM", "OU_SSM"])
@pytest.mark.parametrize("shards", [3, 8])
def test_stitched_kernels_varying_rows(cuda, typ, shards):
    """Parameter rows that differ from row to row (a seeded walk about
    EDGE_THETA), so each chunk's entering row and the score of each
    edge's transition are read from the rows they belong to: the
    stitched kernels against the plain op tables and the unsharded
    kernel route, value within 1e-10 relative and the gradient of every
    row within 1e-8 of its largest component, f64."""
    kern, plain, flat = _time_sharded_routes(cuda, typ, shards)
    n = len(_edge_data()[2])
    walk = np.cumsum(np.random.default_rng(11).normal(
        size=(n, len(EDGE_THETA[typ]))), axis=0)
    rows = np.asarray(EDGE_THETA[typ]) + 0.3 * np.sin(walk / 8.0)

    def vg(fn):
        pm = torch.tensor(rows, dtype=torch.float64, device=cuda,
                          requires_grad=True)
        v = fn(_edge_full(cuda), pm)
        (g,) = torch.autograd.grad(v, pm)
        return v.item(), g.cpu().numpy()

    v, g = vg(kern)
    for ref in (plain, flat):
        rv, rg = vg(ref)
        assert v == pytest.approx(rv, rel=1e-10)
        assert np.max(np.abs(g - rg)) <= 1e-8 * np.max(np.abs(rg))


@pytest.mark.gpu
def test_time_sharded_smooths_on_card(cuda):
    """CTCRW on the edge data with tau ~ s(x), nu and mu1 linear in x
    (every parameter row differs), its time axis in 8 chunks of the card
    through the stitched kernels, against the flat bundle on the CPU:
    the joint nllk within 1e-10 relative and its gradient in every outer
    and inner coefficient within 1e-8 of the largest, f64."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.parallel.batching import make_mesh

    obs, times, ids = _edge_data()
    kw = dict(formulas={"mu1": "~x", "mu2": "~1",
                        "tau": "~s(x, k=5, bs='ts')", "nu": "~x"},
              data={"ID": ids, "time": times, "x": np.sin(times / 40.0),
                    "y1": obs[:, 0], "y2": obs[:, 1]},
              type="CTCRW", response=["y1", "y2"], par0=[0.0, 0.0, 1.0, 1.0])
    got = SDE(**kw, device="cuda", dtype=torch.float64).setup(
        mesh=make_mesh(8, "time", device="cuda:0"), mesh_axis="time")
    want = SDE(**kw, device="cpu", dtype=torch.float64).setup()
    rng = np.random.default_rng(5)
    outer = want.packer.outer_init() + 0.1 * rng.normal(
        size=want.packer.outer_init().shape)
    inner = want.packer.inner_init() + 0.1 * rng.normal(
        size=want.packer.inner_init().shape)
    vals = []
    for b, dev in ((got, cuda), (want, "cpu")):
        o = torch.tensor(outer, dtype=torch.float64, device=dev,
                         requires_grad=True)
        i = torch.tensor(inner, dtype=torch.float64, device=dev,
                         requires_grad=True)
        cf.reset_launches()
        v = b.joint_nllk(b.packer.unpack(o, i))
        go, gi = torch.autograd.grad(v, (o, i))
        vals.append((v.item(), torch.cat([go, gi]).cpu().numpy(),
                     dict(cf.LAUNCHES)))
    (v, g, launches), (rv, rg, _) = vals
    for name in CTCRW_KERNELS:
        assert launches[name] == 8, (name, launches[name])
    assert v == pytest.approx(rv, rel=1e-10)
    assert np.max(np.abs(g - rg)) <= 1e-8 * np.max(np.abs(rg))


@pytest.mark.gpu
@pytest.mark.parametrize("typ", ["CTCRW", "OU_SSM"])
def test_sharded_across_cards(cuda, typ):
    """The time- and track-sharded likelihoods with one shard a card, on
    every visible card (two or more), against the same shards all on
    cuda:0: value within 1e-10 relative, gradient within 1e-8 of its
    largest component, f64; optimizer="device" refuses such a mesh."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.parallel.batching import make_mesh

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    obs, times, ids = _edge_data()
    kw = dict(data={"ID": ids, "time": times, "y1": obs[:, 0],
                    "y2": obs[:, 1]}, type=typ, response=["y1", "y2"],
              par0=[0.0, 0.0, 1.0, 1.0])
    for axis in ("time", "tracks"):
        shards = cards if axis == "time" else min(cards, 3)
        got, want = (
            SDE(**kw, device="cuda", dtype=torch.float64).setup(
                mesh=mesh, mesh_axis=axis)
            for mesh in (make_mesh(shards, axis),
                         make_mesh(shards, axis, device="cuda:0")))
        x = got.packer.outer_init() + 0.05
        vals = []
        for b in (got, want):
            xt = torch.tensor(x, dtype=torch.float64, device=cuda,
                              requires_grad=True)
            v = b.joint_nllk(b.packer.unpack(xt))
            (g,) = torch.autograd.grad(v, xt)
            vals.append((v.item(), g.cpu().numpy()))
        (v, g), (rv, rg) = vals
        assert v == pytest.approx(rv, rel=1e-10)
        assert np.max(np.abs(g - rg)) <= 1e-8 * np.max(np.abs(rg))
    sde = SDE(**kw, device="cuda")
    with pytest.raises(ValueError, match="cards"):
        sde.fit(mesh=make_mesh(cards, "time"), mesh_axis="time",
                optimizer="device")


@pytest.mark.gpu
def test_element_space_stitch_hook_on_card(cuda):
    """fused_filter(sys, stitch=) on the card (K4a, K2, K4b): two slices
    of one f64 CtcrwSystem, the second seeded with the first's total, give
    the whole system's llk and moments (1e-10 of their scale), and the
    same through the plain op table; each kernel launched once a slice."""
    obs, times, ids = _edge_data()
    n, s = len(ids), 264
    pm = torch.tensor([0.1, -0.2, np.log(2.0), 0.0], dtype=torch.float64,
                      device=cuda).expand(n, 4)
    sys = _ctcrw_system(pm, obs, times, ids,
                        torch.tensor(0.1, dtype=torch.float64, device=cuda))

    def cut(x, a, b):
        if isinstance(x, tuple):
            return tuple(cut(v, a, b) for v in x)
        return x[..., a:b].contiguous()

    halves = [sys._replace(**{f: cut(getattr(sys, f), a, b) for f in (
        "Ft", "ct", "Qt", "yd", "reset", "prev_reset", "update")})
        for a, b in ((0, s), (s, n))]
    for ops in (cf.ELEM_OPS["kernels"], cf.ELEM_OPS["plain"]):
        llk, mom = cf.fused_filter(sys, ops)
        box = []

        def first(total):
            box.append(total)
            return cf.stitch_seeds(total[:, None], "filter")[:, 0]

        cf.reset_launches()
        l0, m0 = cf.fused_filter(halves[0], ops, stitch=first)
        l1, m1 = cf.fused_filter(halves[1], ops, stitch=lambda t: box[0])
        if ops is cf.ELEM_OPS["kernels"]:
            for name in ("elem_filter_totals", "block_prefix_filter",
                         "elem_filter_scan"):
                assert cf.LAUNCHES[name] == 2, (name, cf.LAUNCHES[name])
        assert (l0 + l1).item() == pytest.approx(llk.item(), rel=1e-10)
        got = torch.cat([cf.unstack(m0, cf.plan(2, s)),
                         cf.unstack(m1, cf.plan(2, n - s))], dim=-1)
        want = cf.unstack(mom, cf.plan(2, n))
        assert float((got - want).abs().max()) <= 1e-10 * max(
            1.0, float(want.abs().max()))


@pytest.mark.gpu
def test_multiprocess_time_sharded_on_card(cuda, tmp_path):
    """Two processes on cuda:0 (tests/torch_mp_worker.py `run_card`), two
    time chunks each: the f64 joint nllk and gradient of a 2,000-step
    CTCRW and OU_SSM against one process's unsharded kernels (1e-10 /
    1e-8 of the largest component), the same bits on both ranks, each
    kernel of the path launched twice in each process (its two chunks);
    an f64 optimizer="device" fit of the OU_SSM over the two processes,
    every step eager, against one process's device fit (estimates 1e-8,
    nllk 1e-10 relative)."""
    import multiprocessing
    import os

    import torch_mp_worker as worker

    from smoothsde_tpu_torch import SDE

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run_card, args=(
        r, 2, os.path.join(tmp_path, "store"), str(tmp_path)))
        for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and [p.exitcode for p in procs] == [0, 0]
    ranks = [dict(np.load(tmp_path / f"card{r}.npz")) for r in range(2)]
    for k in ranks[0]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    for kind in ("CTCRW", "OU_SSM"):
        b = SDE(**worker.time_case(kind), device="cuda",
                dtype=torch.float64).setup()
        v, go, _ = worker.value_grads(b, *worker.point(b.packer, 5, 0.1))
        got = ranks[0]
        assert abs(got[f"{kind}_v"][0] - v[0]) <= 1e-10 * abs(v[0])
        assert np.max(np.abs(got[f"{kind}_go"] - go)) <= \
            1e-8 * np.max(np.abs(go))
        assert got[f"{kind}_launches"].tolist() == [2] * 6
    one = SDE(**worker.time_case(worker.FIT_CASE), device="cuda",
              dtype=torch.float64).fit(optimizer="device",
                                       maxiter=worker.FIT_MAXITER)
    got = ranks[0]
    assert got["dev_time_conv"][0] == 0 and one.convergence == 0
    assert worker.graph_name(got["dev_time_graph"]) == \
        "eager (collectives across 2 processes)"
    assert np.max(np.abs(got["dev_time_par"] - one.par)) <= 1e-8
    assert abs(got["dev_time_value"][0] - one.value) <= 1e-10 * abs(one.value)
