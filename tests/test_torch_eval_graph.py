"""How a fit's evaluations without inner coefficients run: the bundle's
`value_grad` (infer/fit.py `make_val_grad`), a CUDA graph replayed from
infer/laplace.Graphed where one is sound, else eager.

- On the CPU, with inner coefficients, and on a mesh over several cards
  or processes it runs eagerly: `FitResult.eval_graph` names why, and no
  "graph.capture" or "graph.replay" stage is recorded.
- The evaluation and the FD outer Hessian are the joint nllk's autograd,
  bit for bit.
- The bundle's `value_grad`, and so on a card its graph and memory pool,
  is freed with the bundle by reference counting, without a collection.
- On a card (`gpu`; OU_SSM and BM_SSM in f32, CTCRW in f64 and f32):
  one graph a bundle, whose replays equal the eager evaluation and FD
  Hessian bit for bit; a fit replays once an evaluation and an FD
  gradient, makes the eager fit's evaluations with its results, and
  counts in `LAUNCHES` the eager fit's launches and the capture's two
  runs (the warm-up and the replay check); graphs alive together, whose
  captures share one memory pool, replay in any order; device memory,
  allocated and reserved, stays flat over fits of fresh bundles.

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed:

    python -m pytest tests/test_torch_eval_graph.py --noconftest -q
"""

import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer import fit as fit_mod
from smoothsde_tpu_torch.infer.fit import (
    PORT_STAGES,
    _marginal_grad,
    fd_hessian,
    graph_refusal,
    make_val_grad,
)
from smoothsde_tpu_torch.infer.laplace import _bits
from smoothsde_tpu_torch.ops import ctcrw_fused as cf
from smoothsde_tpu_torch.utils.profiling import NO_TIMER

F32, F64 = torch.float32, torch.float64


def _walk(n, seed, d=2):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(n, d)), axis=0) * 0.1


def _ou(device="cpu", dtype=F64, n=200, seed=1):
    y = _walk(n, seed)
    return SDE(formulas={"mu1": "~1", "mu2": "~1", "tau": "~1",
                         "kappa": "~1"},
               data={"ID": np.zeros(n, int), "time": np.arange(n) * 0.1,
                     "y1": y[:, 0], "y2": y[:, 1]},
               type="OU_SSM", response=["y1", "y2"],
               par0=[0.0, 0.0, 1.0, 1.0], device=device, dtype=dtype)


def _bm_ssm(device="cpu", dtype=F64, n=200, seed=2):
    y = _walk(n, seed)
    return SDE(formulas={"mu1": "~1", "mu2": "~1", "sigma": "~1"},
               data={"ID": np.zeros(n, int), "time": np.arange(n) * 0.5,
                     "y1": y[:, 0], "y2": y[:, 1]},
               type="BM_SSM", response=["y1", "y2"],
               par0=[0.0, 0.0, 0.5], device=device, dtype=dtype)


def _ctcrw(device="cpu", dtype=F64, n=120, seed=3):
    """An AR(1) velocity, its positions, observed with noise."""
    rng = np.random.default_rng(seed)
    v = np.zeros((n, 2))
    for k in range(1, n):
        v[k] = 0.7 * v[k - 1] + rng.normal(size=2)
    y = np.cumsum(v, axis=0) + 0.1 * rng.normal(size=(n, 2))
    return SDE(formulas={"mu1": "~1", "mu2": "~1", "tau": "~1",
                         "nu": "~1"},
               data={"ID": np.zeros(n, int), "time": np.arange(n) * 1.0,
                     "y1": y[:, 0], "y2": y[:, 1]},
               type="CTCRW", response=["y1", "y2"],
               par0=[0.0, 0.0, 1.0, 0.5], device=device, dtype=dtype)


def _bm_re(device="cpu"):
    """Three BM tracks with a random intercept in mu."""
    rng = np.random.default_rng(7)
    ids = np.repeat(np.arange(3), 60)
    drift = np.array([-0.4, 0.1, 0.5])[ids]
    z = np.concatenate([np.cumsum(drift[ids == k] + 0.7 * rng.normal(
        size=60)) for k in range(3)])
    return SDE(data={"ID": ids, "time": np.tile(np.arange(60.0), 3),
                     "z": z},
               type="BM", response="z",
               formulas={"mu": "~s(ID, bs='re')", "sigma": "~1"},
               device=device, dtype=F64)


CPU_MODELS = {"ou_ssm": _ou, "bm_ssm": _bm_ssm, "ctcrw": _ctcrw}


def _points(packer, dtype, device, k=3, seed=5):
    """The start and k points around it, as tensors."""
    x0 = packer.outer_init()
    rng = np.random.default_rng(seed)
    pts = [x0] + [x0 + 0.05 * rng.normal(size=x0.shape) for _ in range(k)]
    return [torch.tensor(p, dtype=dtype, device=device) for p in pts]


def _same(a, b):
    return a.shape == b.shape and bool((_bits(a) == _bits(b)).all())


def test_the_replay_stage_is_a_port_stage():
    assert "graph.replay" in PORT_STAGES


# a short fit: the plain CTCRW kernels take ~0.2 s an evaluation on the CPU
SHORT = {"maxiter": 2, "compute_sdreport": False}


@pytest.mark.parametrize("make,why,kw", [
    (_ou, "eager (cpu device)", {}),
    (_ctcrw, "eager (cpu device)", SHORT),
    (_bm_re, "eager (inner coefficients)", {}),
])
def test_eager_off_the_card_and_with_inner_coefficients(make, why, kw):
    res = make().fit(**kw)
    if not kw:
        assert res.convergence == 0
    assert res.eval_graph == why
    assert "graph.capture" not in res.timings
    assert "graph.replay" not in res.timings


def _bundle(device="cuda", n_inner=0, mesh=None):
    return SimpleNamespace(device=torch.device(device), mesh=mesh,
                           packer=SimpleNamespace(n_inner=n_inner))


@pytest.mark.parametrize("bundle,why", [
    (_bundle(), None),
    (_bundle(mesh=SimpleNamespace(processes=None, n_cards=1)), None),
    (_bundle("cpu"), "cpu device"),
    (_bundle(n_inner=3), "inner coefficients"),
    (_bundle(mesh=SimpleNamespace(processes=None, n_cards=2)), "2 cards"),
    (_bundle(mesh=SimpleNamespace(processes=object(), n_proc=2,
                                  n_cards=2)),
     "collectives across 2 processes"),
])
def test_graph_refusal_names_why_a_graph_is_not_sound(bundle, why):
    assert graph_refusal(bundle) == why


@pytest.mark.parametrize("model", sorted(CPU_MODELS))
def test_an_evaluation_is_the_joint_autograd_bit_for_bit(model):
    bundle = CPU_MODELS[model]().bundle()
    packer = bundle.packer
    vg = make_val_grad(bundle)
    for x in _points(packer, F64, "cpu"):
        v, g, b = vg(x.numpy())
        xg = x.clone().requires_grad_(True)
        want = bundle.joint_nllk(packer.unpack(xg))
        (want_g,) = torch.autograd.grad(want, xg)
        assert v == float(want.detach()) and len(b) == 0
        assert np.array_equal(g, want_g.numpy())


@pytest.mark.parametrize("model", ["bm_ssm", "ou_ssm"])
def test_the_fd_hessian_is_the_joint_autograd_bit_for_bit(model):
    bundle = CPU_MODELS[model]().bundle()
    packer = bundle.packer
    make_val_grad(bundle)
    x = _points(packer, F64, "cpu", k=1)[1]

    def autograd_grad(xp):
        xg = xp.detach().requires_grad_(True)
        v = bundle.joint_nllk(packer.unpack(xg))
        return torch.autograd.grad(v, xg)[0]

    got = fd_hessian(_marginal_grad(bundle, x.new_zeros(0), NO_TIMER), x,
                     1e-4)
    want = fd_hessian(autograd_grad, x, 1e-4)
    assert _same(got, want)


@pytest.mark.parametrize("model", sorted(CPU_MODELS))
def test_a_bundle_is_freed_without_a_collection(model):
    gc.disable()
    try:
        sde = CPU_MODELS[model]()
        res = sde.fit(**SHORT)
        held = weakref.ref(sde.bundle().value_grad)
        del sde, res
        assert held() is None
    finally:
        gc.enable()


def test_bits_compare_bit_for_bit():
    for dtype in (torch.float16, F32, F64):
        nan = torch.tensor([float("nan"), 1.0], dtype=dtype)
        assert _same(nan, nan.clone())
        assert not _same(torch.tensor([0.0], dtype=dtype),
                         torch.tensor([-0.0], dtype=dtype))
    flags = torch.tensor([True, False])
    assert _same(flags, flags.clone())
    assert not _same(flags, ~flags)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

GPU_MODELS = {
    "ou_ssm_f32": lambda n=2000: _ou("cuda", F32, n=n),
    "bm_ssm_f32": lambda n=2000: _bm_ssm("cuda", F32, n=n),
    "ctcrw_f64": lambda n=2000: _ctcrw("cuda", F64, n=n),
    "ctcrw_f32": lambda n=2000: _ctcrw("cuda", F32, n=n),
}


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graphed(model):
    bundle = GPU_MODELS[model]().bundle()
    make_val_grad(bundle)
    return bundle, bundle.value_grad


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(GPU_MODELS))
def test_replays_equal_the_eager_evaluation_bit_for_bit(cuda, model):
    bundle, vg = _graphed(model)
    for x in _points(bundle.packer, bundle.dtype, cuda):
        got, want = vg(x), vg.fn(x)
        assert all(_same(a, b) for a, b in zip(got, want)), x
    assert vg.status == {str(bundle.dtype): "graph"}


@pytest.mark.gpu
def test_live_graphs_that_share_the_pool_replay_in_any_order(cuda):
    # every capture on the card shares one memory pool: a graph captured
    # later may take blocks that an earlier one writes while it replays
    graphed = [_graphed(m) for m in ("ou_ssm_f32", "ctcrw_f64",
                                     "ou_ssm_f32", "bm_ssm_f32")]
    pts = [_points(b.packer, b.dtype, cuda) for b, _ in graphed]
    for k in (3, 1, 0, 2):
        for i in (2, 0, 3, 1, 0):
            vg = graphed[i][1]
            got, want = vg(pts[i][k]), vg.fn(pts[i][k])
            assert all(_same(a, b) for a, b in zip(got, want)), (i, k)
    assert all(vg.status == {str(b.dtype): "graph"} for b, vg in graphed)


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(GPU_MODELS))
def test_the_fd_hessian_from_replays_equals_the_eager_one(cuda, model):
    bundle, vg = _graphed(model)
    x = _points(bundle.packer, bundle.dtype, cuda, k=1)[1]
    got = fd_hessian(lambda p: vg(p)[1], x, 1e-4)
    want = fd_hessian(lambda p: vg.fn(p)[1], x, 1e-4)
    assert vg.status == {str(bundle.dtype): "graph"}
    assert _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(GPU_MODELS))
def test_a_graphed_fit_is_the_eager_fit(cuda, model, monkeypatch):
    make = GPU_MODELS[model]
    make().fit()  # the kernels' load, lazy set-up
    with monkeypatch.context() as m:
        m.setattr(fit_mod, "graph_refusal", lambda bundle: "asked")
        sde = make()
        sde.setup()
        cf.reset_launches()
        eager = sde.fit()
        eager_launches = dict(cf.LAUNCHES)
        one = sde.bundle().value_grad.fn  # one eager evaluation
        cf.reset_launches()
        one(_points(sde.bundle().packer, sde.bundle().dtype, cuda, k=0)[0])
        per_eval = dict(cf.LAUNCHES)
    sde = make()
    sde.setup()
    cf.reset_launches()
    res = sde.fit()
    assert eager.eval_graph == "eager (asked)"
    assert "graph.replay" not in eager.timings
    assert res.eval_graph == "graph"
    assert res.counts["evals"] == eager.counts["evals"]
    assert res.value == eager.value
    assert np.array_equal(res.par, eager.par)
    assert np.array_equal(res.cov_fixed, eager.cov_fixed, equal_nan=True)
    n_out = len(res.par)
    # one replay an evaluation and an FD gradient
    assert res.timings["graph.capture"]["calls"] == 1
    assert res.timings["graph.replay"]["calls"] == \
        res.counts["evals"] + 4 * n_out
    # the launches that ran: the eager fit's, and the capture's warm-up
    # and replay check
    assert any(per_eval.values())
    assert dict(cf.LAUNCHES) == {
        k: eager_launches[k] + 2 * per_eval[k] for k in cf.LAUNCHES}


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(GPU_MODELS))
def test_device_memory_stays_flat_over_fits(cuda, model):
    make = GPU_MODELS[model]
    make(100_000).fit()  # the kernels' load, the capture stream's set-up
    torch.cuda.synchronize()
    after = []
    for _ in range(10):  # fresh bundles; no collection asked for
        res = make(100_000).fit()
        assert res.eval_graph == "graph"
        torch.cuda.synchronize()
        after.append((torch.cuda.memory_allocated(),
                      torch.cuda.memory_reserved()))
    # nothing of a fit's graph is left allocated, and its blocks are
    # taken again by the next capture, not new memory
    assert after[-1][0] <= 1.05 * after[0][0], after
    assert after[-1][1] <= 1.05 * after[0][1], after
