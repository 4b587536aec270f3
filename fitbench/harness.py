"""One run of one benchmark cell: set-up, the measured window of fits,
the traced fits, the metrics, and the comparison that decides `correct`.

A cell (`BENCHMARK.json` "workloads") names a configuration and a
traffic mix; everything else is found by name:
  configs/<config>.json      SDE type, formulas, par0, dtype, truth
  traffic/<traffic>.json     tracks and steps a fit, dt law, pool, optimizer
  sim/<TYPE>.py              simulate(rng, truth, n_paths, steps, dt_law)
  reference/<TYPE>.py        names, truth, start, nllk (check.py)
  work/<TYPE>.py             eval_bytes(rows, dims, itemsize)
  metrics/<metric>.py        read(run) -> number or None
  limits/<cell>.json         the limit of each number compared
  launches/*.json            the csrc kernels each counted launch runs
sim/, reference/ and work/ take `<config>.py` before `<TYPE>.py`, so a
configuration that the type's files do not describe brings its own.
Each fit is one job, closed loop: SDE(...), .setup(), .fit(), the
estimates and standard errors on the host. Job 0 is set-up's warm fit;
the traced run profiles the next `trace_fits` jobs; the window runs the
jobs after them back to back until `seconds` have passed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "smoothsde_tpu")


def load(path: Path):
    """Import the file `path` as a module of its own."""
    name = "fitbench_" + "_".join(path.relative_to(BENCH_DIR).with_suffix(
        "").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """A workload of BENCHMARK.json with its files loaded; `overrides`
    replaces traffic entries (the CPU tests' tiny sizes)."""

    def __init__(self, name, bench=None, overrides=None):
        spec = json.loads(Path(bench or ROOT / "BENCHMARK.json").read_text())
        w = _named(spec["workloads"], name, "workload")
        c = _named(spec["configs"], w["config"], "config")
        self.name, self.chips = name, w["chips"]
        self.config = json.loads((ROOT / c["file"]).read_text())
        self.traffic = json.loads(
            (BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        self.traffic.update(overrides or {})

        def find(sub):
            for stem in (w["config"], self.config["type"]):
                if (BENCH_DIR / sub / f"{stem}.py").exists():
                    return load(BENCH_DIR / sub / f"{stem}.py")
            raise FileNotFoundError(f"no {sub}/{w['config']}.py or "
                                    f"{sub}/{self.config['type']}.py")

        self.sim, self.reference, self.work = (
            find(sub) for sub in ("sim", "reference", "work"))
        self.limits = json.loads(
            (BENCH_DIR / "limits" / f"{name}.json").read_text())

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]

    @property
    def dims(self):
        return len(self.config["response"])


class Inputs:
    """The cell's data, made from the seed at set-up: `tracks` paths of
    `pool_steps` steps each, and for every job and track slot an offset
    drawn without replacement, so that no two jobs fit the same track.
    Job j's track i is path i's `steps` rows from offset [i, j]."""

    MAX_JOBS = 100_000

    def __init__(self, cell, seed):
        tr = cell.traffic
        rng = np.random.default_rng(seed)
        self.times, self.obs = cell.sim.simulate(
            rng, cell.config["truth"], tr["tracks"], tr["pool_steps"],
            tr["dt"])
        self.steps = tr["steps"]
        avail = tr["pool_steps"] - self.steps + 1
        self.offsets = np.stack([
            rng.choice(avail, size=min(avail, self.MAX_JOBS), replace=False)
            for _ in range(tr["tracks"])])
        self.response = cell.config["response"]

    def _rows(self, j):
        if j >= self.offsets.shape[1]:
            raise RuntimeError(f"the pool holds {self.offsets.shape[1]} "
                               "distinct jobs; raise pool_steps")
        for i, o in enumerate(self.offsets[:, j]):
            yield i, slice(o, o + self.steps)

    def job(self, j):
        """The data frame (dict of columns) of job j."""
        ids, times, obs = [], [], []
        for i, rows in self._rows(j):
            ids.append(np.full(self.steps, i, np.int32))
            times.append(self.times[i, rows] - self.times[i, rows.start])
            obs.append(self.obs[i, rows])
        obs = np.concatenate(obs)
        data = {"ID": np.concatenate(ids), "time": np.concatenate(times)}
        for d, name in enumerate(self.response):
            data[name] = obs[:, d]
        return data

    def arrays(self, j):
        """Job j for the reference: obs (steps, tracks, D) and the
        intervals (steps, tracks), the last row's 1 (not used)."""
        obs = np.stack([self.obs[i, rows] for i, rows in self._rows(j)], 1)
        t = np.stack([self.times[i, rows] for i, rows in self._rows(j)], 1)
        dt = np.concatenate([np.diff(t, axis=0), np.ones((1, t.shape[1]))])
        return obs, dt


def _span(name):
    import torch

    return torch.profiler.record_function(name)


def run_job(cell, inputs, j, device, dtype, sync):
    """One fit, timed: the record of what the host got back."""
    from smoothsde_tpu_torch import SDE

    cfg, tr = cell.config, cell.traffic
    data = inputs.job(j)
    t0 = time.perf_counter()
    with _span("fitbench.build"):
        sde = SDE(formulas=dict(cfg["formulas"]), data=data,
                  type=cfg["type"], response=list(cfg["response"]),
                  par0=list(cfg["par0"]), device=device, dtype=dtype)
        sde.setup()
        sync()
    t1 = time.perf_counter()
    with _span("fitbench.fit"):
        res = sde.fit(optimizer=tr["optimizer"], **tr["fit"])
    with _span("fitbench.read"), np.errstate(invalid="ignore"):
        par = np.array(res.par, float)
        cov = np.array(res.cov_fixed, float)
        se = np.sqrt(np.diag(cov))  # nan where cov_fixed is not definite
    t2 = time.perf_counter()
    prec = np.linalg.pinv(cov)
    return {"job": j, "build_s": t1 - t0, "fit_s": t2 - t1,
            "evals": res.counts["evals"], "timings": res.timings,
            "value": float(res.value), "par": par, "se": se, "prec": prec,
            "names": list(res.par_names), "converged": res.convergence == 0,
            "via": res.convergence_via, "optimizer": res.optimizer,
            "graph": res.device_graph}


def window(cell, inputs, first, seconds, device, dtype, sync, log):
    """Fits back to back from job `first` until `seconds` have passed;
    (records, elapsed s). A fit that raises is recorded as failed."""
    recs, j = [], first
    t0 = time.perf_counter()
    while True:
        try:
            recs.append(run_job(cell, inputs, j, device, dtype, sync))
        except Exception:  # a failed fit: counted, the loop goes on
            log(f"job {j} failed:\n{traceback.format_exc()}")
            recs.append({"job": j, "error": True})
        j += 1
        if time.perf_counter() - t0 >= seconds:
            return recs, time.perf_counter() - t0


def traced(cell, inputs, jobs, device, dtype, sync):
    """The profiled fits: their records and the reduced trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fitbench import trace
    from smoothsde_tpu_torch.ops import ctcrw_fused

    launches0 = dict(ctcrw_fused.LAUNCHES)
    with trace.stage_spans(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recs = [run_job(cell, inputs, j, device, dtype, sync) for j in jobs]
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out = trace.reduce(prof.events(), trace.csrc_kernel_names(ROOT))
    launches = {k: v - launches0.get(k, 0)
                for k, v in ctcrw_fused.LAUNCHES.items()
                if v != launches0.get(k, 0)}
    expected = trace.expected_kernels(launches, trace.launch_map(BENCH_DIR))
    out.update(fits=recs, window_s=window_s, launches=launches,
               expected_kernels=expected,
               kernels_match=expected == out["csrc_by_name"],
               evals=sum(r["evals"] for r in recs))
    return out


def failed(rec):
    return rec.get("error", False) or not rec["converged"]


def check(cell, inputs, recs, seed, device, log):
    """The worst of each number compared over a sample of the window's
    fits drawn from the seed (fitbench/check.py)."""
    from fitbench import check as cmp

    good = [r for r in recs if not failed(r)]
    k = min(cell.traffic["check_fits"], len(good))
    pick = np.random.default_rng([seed, 2]).choice(len(good), size=k,
                                                   replace=False)
    worst = {n: 0.0 for n in cmp.NUMBERS}
    for i in sorted(pick):
        rec = good[i]
        obs, dt = inputs.arrays(rec["job"])
        nums = cmp.compare(cell, rec, obs, dt, device)
        log(f"job {rec['job']}: " + ", ".join(
            f"{n} {v:.6g}" for n, v in nums.items()))
        for n, v in nums.items():
            if not (math.isnan(worst[n]) or v <= worst[n]):
                worst[n] = v  # the largest, or nan once one is nan
    return worst, k


def peak_of(kind):
    peaks = json.loads((BENCH_DIR / "peaks.json").read_text())
    return peaks.get(kind)


def power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(cell, seed, seconds, trace, t_start, device="cuda", log=None):
    """One run of `cell`; returns the result object (run.py prints it)
    and the lines of numbers compared."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = getattr(torch, cell.config["dtype"])
    if on_card:
        from smoothsde_tpu_torch.ops import _kernels

        _kernels.load()  # built once per checkout, at its first run
    inputs = Inputs(cell, seed)
    run_job(cell, inputs, 0, device, dtype, sync)  # the warm fit
    gc.collect()
    gc.freeze()  # set-up's objects: no collection walks them again
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    n_traced = cell.traffic["trace_fits"] if trace else 0
    tr = (traced(cell, inputs, range(1, 1 + n_traced), device, dtype, sync)
          if trace else None)
    recs, window_s = window(cell, inputs, 1 + n_traced, seconds, device,
                            dtype, sync, log)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    n_failed = sum(failed(r) for r in recs)
    good = [r for r in recs if not failed(r)]
    ctx = SimpleNamespace(setup_s=setup_s, window_s=window_s, fits=good,
                          attempted=len(recs), traced=tr, peak=None,
                          eval_bytes=None)
    if tr is not None:
        kind = torch.cuda.get_device_name(0)
        ctx.peak = peak_of(kind)
        ctx.eval_bytes = cell.work.eval_bytes(
            cell.traffic["tracks"] * cell.traffic["steps"], cell.dims,
            torch.empty((), dtype=dtype).element_size())
        log(f"traced {len(tr['fits'])} fits: {tr['window_s']:.3f} s, "
            f"busy {tr['busy_s']:.4f} s, {tr['device_events']} device "
            f"events, {tr['csrc_kernels']} csrc kernels, "
            f"{sum(tr['launches'].values())} launches counted; peak "
            f"{ctx.peak}; card {power_limit()}")
        if not tr["kernels_match"]:
            log("the csrc kernels the profiler saw, by name, "
                f"{tr['csrc_by_name']}, are not those that the counted "
                f"launches {tr['launches']} run, {tr['expected_kernels']}: "
                "events were dropped, or launches ran uncounted (a CUDA "
                "graph) or unmapped; kernels.csrc_us_per_eval is not "
                "reported from this run")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load(BENCH_DIR / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    for r in recs:
        log(f"job {r['job']}: " + ("failed" if r.get("error") else
            f"build {r['build_s']:.4f} s, fit {r['fit_s']:.4f} s, "
            f"{r['evals']} evals, via {r['via']}"))
    t_check = time.perf_counter()
    worst, n_checked = check(cell, inputs, recs, seed, device, log)
    log(f"reference check of {n_checked} fits: "
        f"{time.perf_counter() - t_check:.2f} s")
    checks = {n: {"value": v, "limit": cell.limits[n]}
              for n, v in worst.items()}
    checks["failed_fits"] = {"value": n_failed, "limit": 0}
    correct = bool(good) and n_checked > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(recs),
              "failed": n_failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    lines = [f"check {n} {c['value']!r} limit {c['limit']!r}"
             for n, c in checks.items()]
    return result, lines
