"""utils/profiling.py and fit_model's stage timings, profiler trace and
sdreport_mode on the port against the JAX package, in f64 on the CPU:

- the two packages' StageTimers give equal summaries on one stage
  sequence under a fake clock;
- the BM fit of tests/test_sde_api.py `test_timings_recorded` gives the
  same `timings` stage names and schema in both packages, besides the
  port's own stages (`PORT_STAGES`: the build, the evaluation's
  enqueue, the host reads), exactly those that its path records; the
  device optimizer's stages are JAX stage names and those port stages;
- `profile_dir` writes a torch.profiler trace (`trace` with None is a
  no-op);
- sdreport_mode="device" (the FD points stacked, `fd_hessian`) agrees
  with "host", and the port's cov_fixed with the JAX package's, each
  entry within 1e-6 of the matrix's largest, on that BM fit; "device" against "host" also on a
  fit with inner coefficients (the marginal's gradient at bhat);
- an unknown sdreport_mode raises.
"""

import json
import time
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu.utils import profiling as jax_profiling
from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.fit import PORT_STAGES
from smoothsde_tpu_torch.utils import profiling

F64 = torch.float64
STAGES = {"marginal_nllk_grad", "outer_hessian_fd", "joint_precision",
          "device_lbfgs", "device_polish"}
FIELDS = {"calls", "first_s", "steady_s", "total_s"}
BUILD = {"build.columns", "build.design", "build.params", "build.rows"}


def _bm_data():
    """tests/test_sde_api.py test_timings_recorded's data."""
    rng = np.random.default_rng(32)
    n = 200
    z = np.cumsum(rng.normal(size=n))
    return {"ID": np.zeros(n, int), "time": np.arange(n, dtype=float),
            "z": z}


def _re_data():
    """Three BM tracks with a random intercept in mu."""
    rng = np.random.default_rng(7)
    ids = np.repeat(np.arange(3), 60)
    drift = np.array([-0.4, 0.1, 0.5])[ids]
    z = np.concatenate([np.cumsum(drift[ids == k] + 0.7 * rng.normal(
        size=60)) for k in range(3)])
    return {"ID": ids, "time": np.tile(np.arange(60, dtype=float), 3),
            "z": z}


def _run_stages(timer, clock, monkeypatch):
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    for name in ("a", "b", "a", "a", "c", "b"):
        with timer.stage(name):
            pass
    return timer.summary()


def test_stage_timers_agree(monkeypatch):
    ticks = [0.0, 1.5, 2.0, 2.25, 3.0, 3.5, 4.0, 4.125, 5.0, 7.0, 8.0,
             8.75]
    got = _run_stages(profiling.StageTimer(), iter(ticks), monkeypatch)
    want = _run_stages(jax_profiling.StageTimer(), iter(ticks), monkeypatch)
    assert got == want
    assert got["a"] == {"calls": 3, "first_s": 1.5, "steady_s": 0.3125,
                        "total_s": 2.125}


def test_timings_have_the_jax_schema():
    res = SDE(data=_bm_data(), type="BM", response="z", device="cpu",
              dtype=F64).fit()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = JaxSDE(data=_bm_data(), type="BM", response="z").fit()
    assert set(res.timings) - set(PORT_STAGES) == set(jres.timings)
    assert set(jres.timings) <= STAGES
    # the host loop's port stages: the build, each evaluation's enqueue,
    # its reads of the device
    assert set(res.timings) & set(PORT_STAGES) == BUILD | {
        "eval.enqueue", "host_read"}
    for name, t in res.timings.items():
        assert set(t) == FIELDS
        if name in jres.timings:
            assert set(t) == set(jres.timings[name])
    t = res.timings["marginal_nllk_grad"]
    assert t["calls"] >= 2 and t["first_s"] >= t["steady_s"] * 0.5
    assert res.timings["outer_hessian_fd"]["calls"] == 1


def test_device_optimizer_stages_are_jax_names():
    res = SDE(data=_re_data(), type="BM", response="z",
              formulas={"mu": "~s(ID, bs='re')", "sigma": "~1"},
              device="cpu", dtype=F64).fit(optimizer="device")
    assert {"device_lbfgs", "joint_precision"} <= \
        set(res.timings) - set(PORT_STAGES) <= STAGES
    # the build, the flags' and the copy's reads, the polish's evaluations
    # (no CUDA graph on the CPU: no capture)
    assert set(res.timings) & set(PORT_STAGES) == BUILD | {
        "eval.enqueue", "host_read"}
    for t in res.timings.values():
        assert set(t) == FIELDS


def test_profile_dir_writes_a_trace(tmp_path):
    log = tmp_path / "prof"
    SDE(data=_bm_data(), type="BM", response="z", device="cpu",
        dtype=F64).fit(profile_dir=str(log), compute_sdreport=False)
    files = list(log.iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    with profiling.trace(None):
        pass


def _matrix_close(got, want, rel=1e-6):
    """Every entry within rel of the largest entry of want."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rel * np.max(np.abs(want))


def test_sdreport_device_matches_host_and_jax():
    fits = {m: SDE(data=_bm_data(), type="BM", response="z", device="cpu",
                   dtype=F64).fit(sdreport_mode=m)
            for m in ("host", "device")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = JaxSDE(data=_bm_data(), type="BM", response="z").fit()
    _matrix_close(fits["device"].H_marg, fits["host"].H_marg)
    for res in fits.values():
        _matrix_close(res.cov_fixed, jres.cov_fixed)


def test_sdreport_device_matches_host_with_inner_coefficients():
    def fit(mode):
        return SDE(data=_re_data(), type="BM", response="z",
                   formulas={"mu": "~s(ID, bs='re')", "sigma": "~1"},
                   device="cpu", dtype=F64).fit(sdreport_mode=mode)

    host, device = fit("host"), fit("device")
    _matrix_close(device.H_marg, host.H_marg)
    _matrix_close(device.joint_precision, host.joint_precision)


def test_unknown_sdreport_mode_raises():
    with pytest.raises(ValueError, match="sdreport_mode"):
        SDE(data=_bm_data(), type="BM", response="z", device="cpu",
            dtype=F64).fit(sdreport_mode="tpu")
