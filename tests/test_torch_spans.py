"""The port's spans and counters inside a fit (utils/profiling.StageTimer):

- with the profiler off no `record_function` is entered;
- under a recording torch.profiler the build's four stages, each
  evaluation's "eval.enqueue" and every "host_read" are "stage.<name>"
  ranges, each evaluation's inside its "marginal_nllk_grad";
- `FitResult.timings` holds the build's stages once per fit, every fit
  of the bundle;
- "host_read" counts the fit's reads of the device: two an evaluation
  without inner coefficients (value, gradient), three with them (and
  bhat) besides the inner Newton's, plus the sdreport's copies;
- on a card (`gpu`), every call that torch reports as synchronizing
  inside `fit()` is one "host_read" (OU_SSM, CTCRW in f64 and f32, BM
  with a random effect), and each CUDA graph's capture a
  "graph.capture": the evaluation's once a bundle without inner
  coefficients, the device optimizer's step once a fit.

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed:

    python -m pytest tests/test_torch_spans.py --noconftest -q
"""

import collections
import contextlib
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from torch.profiler import ProfilerActivity, profile

from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.fit import PORT_STAGES
from smoothsde_tpu_torch.utils import profiling

F64 = torch.float64
BUILD = ("build.columns", "build.design", "build.params", "build.rows")


def _ou_data(n=300, seed=1):
    rng = np.random.default_rng(seed)
    return {"ID": np.zeros(n, int), "time": np.arange(n) * 0.1,
            "y1": np.cumsum(rng.normal(size=n)) * 0.1,
            "y2": np.cumsum(rng.normal(size=n)) * 0.1}


def _ou(device="cpu", dtype=F64, n=300, seed=1):
    return SDE(formulas={"mu1": "~1", "mu2": "~1", "tau": "~1",
                         "kappa": "~1"},
               data=_ou_data(n, seed), type="OU_SSM", response=["y1", "y2"],
               par0=[0.0, 0.0, 1.0, 1.0], device=device, dtype=dtype)


def _bm():
    """A BM track (few torch operations an evaluation: cheap to
    profile)."""
    rng = np.random.default_rng(32)
    n = 200
    return SDE(data={"ID": np.zeros(n, int),
                     "time": np.arange(n, dtype=float),
                     "z": np.cumsum(rng.normal(size=n))},
               type="BM", response="z", device="cpu", dtype=F64)


def _re_data():
    """Three BM tracks with a random intercept in mu."""
    rng = np.random.default_rng(7)
    ids = np.repeat(np.arange(3), 60)
    drift = np.array([-0.4, 0.1, 0.5])[ids]
    z = np.concatenate([np.cumsum(drift[ids == k] + 0.7 * rng.normal(
        size=60)) for k in range(3)])
    return {"ID": ids, "time": np.tile(np.arange(60, dtype=float), 3),
            "z": z}


def _ctcrw(device="cpu", dtype=F64, n=2000, seed=3):
    """A CTCRW track: an AR(1) velocity, its positions, observed with
    noise (the fused kernels' route on a card)."""
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
    return SDE(data=_re_data(), type="BM", response="z",
               formulas={"mu": "~s(ID, bs='re')", "sigma": "~1"},
               device=device, dtype=F64)


def _ranges(prof):
    """(start, end, name) of every "stage.<name>" range, times in us."""
    return [(e.time_range.start, e.time_range.end, e.name[len("stage."):])
            for e in prof.events() if e.name.startswith("stage.")]


def _parent(rng, ranges):
    """The name of the innermost other range around `rng`, or None."""
    s, e, _ = rng
    around = [r for r in ranges if r is not rng and r[0] <= s
              and e <= r[1] and (r[1] - r[0]) > (e - s)]
    return max(around, key=lambda r: r[0])[2] if around else None


@contextlib.contextmanager
def _parents_of(name, monkeypatch):
    """A Counter, filled while the block runs, of the stage that each
    "name" stage opened inside (None: none)."""
    out, open_ = collections.Counter(), []
    orig = profiling.StageTimer.stage

    @contextlib.contextmanager
    def stage(self, n):
        if n == name:
            out[open_[-1] if open_ else None] += 1
        open_.append(n)
        try:
            with orig(self, n):
                yield
        finally:
            open_.pop()

    monkeypatch.setattr(profiling.StageTimer, "stage", stage)
    yield out


def test_no_record_function_with_the_profiler_off(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    res = _ou().fit()
    assert res.convergence == 0
    assert res.timings["host_read"]["calls"] > 0


def test_stages_are_profiler_ranges_nested_in_their_parents():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _bm().fit(compute_sdreport=False)
    ranges = _ranges(prof)
    names = collections.Counter(r[2] for r in ranges)
    for name in BUILD + ("eval.enqueue", "host_read",
                         "marginal_nllk_grad"):
        assert names[name] == res.timings[name]["calls"], name
    for r in ranges:
        if r[2] in ("eval.enqueue", "host_read"):
            assert _parent(r, ranges) == "marginal_nllk_grad", r


def test_sdreport_reads_nest_in_its_stage():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _bm().fit(sdreport_mode="device")
    ranges = _ranges(prof)
    parents = collections.Counter(
        _parent(r, ranges) for r in ranges if r[2] == "host_read")
    evals = res.timings["marginal_nllk_grad"]["calls"]
    assert parents == {"marginal_nllk_grad": 2 * evals,
                       "outer_hessian_fd": 1}


def test_build_stages_once_in_every_fit():
    sde = _ou()
    for _ in range(2):
        res = sde.fit()
        assert [k for k in res.timings if k.startswith("build.")] == \
            list(BUILD)
        for name in BUILD:
            assert res.timings[name]["calls"] == 1
            assert res.timings[name]["total_s"] > 0


@pytest.mark.parametrize("mode,copies", [("host", 0), ("device", 1)])
def test_two_host_reads_an_evaluation_without_inner_coefficients(mode,
                                                                 copies):
    res = _ou().fit(sdreport_mode=mode)
    assert res.timings["host_read"]["calls"] == \
        2 * res.counts["evals"] + copies
    assert res.timings["eval.enqueue"]["calls"] == res.counts["evals"]
    assert set(res.timings) & set(PORT_STAGES) == set(BUILD) | {
        "eval.enqueue", "host_read"}


def test_three_host_reads_an_evaluation_with_inner_coefficients(
        monkeypatch):
    with _parents_of("host_read", monkeypatch) as parents:
        res = _bm_re().fit(sdreport_mode="device")
    evals = res.timings["marginal_nllk_grad"]["calls"]
    assert evals == res.counts["evals"]
    # the evaluation's value, gradient and bhat; the inner Newton's reads
    # inside the evaluation's enqueue; the FD Hessian's and the joint
    # precision's copies
    assert parents["marginal_nllk_grad"] == 3 * evals
    assert parents["eval.enqueue"] > 0
    assert parents["outer_hessian_fd"] >= 1
    assert parents["joint_precision"] == 1
    assert sum(parents.values()) == res.timings["host_read"]["calls"]


def test_device_optimizer_reads_its_flags():
    res = _ou().fit(optimizer="device")
    # the start's flag, one a step, the one copy back
    assert res.timings["host_read"]["calls"] == res.device_steps + 2
    assert "graph.capture" not in res.timings  # no CUDA graph on the CPU


def _counted_fit(sde, optimizer):
    """The fit's timings and the synchronizing calls torch reported
    inside it, by the place that made each."""
    sites = collections.Counter()
    # the mode is set outside the recording: setting it may warn itself
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = sde.fit(optimizer=optimizer)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchronizing" in str(w.message):
            sites[f"{w.filename}:{w.lineno}"] += 1
    return res, sites


# model -> a fresh SDE on the card (OU_SSM: the diag kernels; CTCRW: the
# fused kernels, ops/ctcrw_fused.py; BM with a random effect: the Laplace
# layer's graphs)
GPU_MODELS = {
    "ou_ssm": lambda: _ou("cuda", torch.float32, n=2000),
    "ctcrw_f64": lambda: _ctcrw("cuda", F64),
    "ctcrw_f32": lambda: _ctcrw("cuda", torch.float32),
    "bm_re": lambda: _bm_re("cuda"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["scipy", "device"])
@pytest.mark.parametrize("model", sorted(GPU_MODELS))
def test_every_sync_in_a_fit_is_a_host_read(model, optimizer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    make = GPU_MODELS[model]
    make().fit(optimizer=optimizer)  # the kernels' load, lazy set-up
    sde = make()
    sde.setup()
    torch.cuda.synchronize()
    res, sites = _counted_fit(sde, optimizer)
    assert sum(sites.values()) == res.timings["host_read"]["calls"], sites
    if model == "bm_re":
        # the Laplace layer's graphs, captured in this bundle's first fit;
        # no graph of the evaluation
        assert res.timings["graph.capture"]["calls"] >= 1
        assert res.eval_graph == "eager (inner coefficients)"
        if optimizer == "device":
            assert res.device_graph == "eager"
    elif optimizer == "device":
        # the device optimizer's step, captured once a fit, and the
        # evaluation that the FD Hessian replays, once a bundle
        assert res.timings["graph.capture"]["calls"] == 2
        assert res.device_graph == "graph"
        assert res.eval_graph == "graph"
    else:
        # the evaluation, captured once a bundle
        assert res.timings["graph.capture"]["calls"] == 1
        assert res.eval_graph == "graph"
