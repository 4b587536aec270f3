"""CPU tests of the benchmark harness (fitbench/): the cells resolve to
their files, the names follow the contract, the reference agrees with a
dense Gaussian likelihood, the problem's bytes follow their formula, no
forbidden module is loaded, and a run's loop on the CPU at a tiny size
is judged correct, its control and every fault not. Run with

    python -m pytest fitbench/tests -q

The `gpu` test runs the control at a cell's own size on a card.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from fitbench import check, control, harness, trace  # noqa: E402
from fitbench.reference import _filter  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TYPES = sorted({harness.Cell(c).config["type"] for c in CELLS})
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"tracks": 2, "steps": 200, "pool_steps": 500, "trace_fits": 0,
        "check_fits": 1}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.Cell(name)
    assert cell.config["type"] in TYPES
    assert set(check.NUMBERS) <= set(cell.limits)
    for m in cell.end_to_end + cell.per_layer:
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    assert {m["name"] for m in cell.end_to_end} >= {"fit_s", "setup_s"}
    assert cell.per_layer


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names[:len(SPEC["configs"]) + len(CELLS)])) == len(
        SPEC["configs"]) + len(CELLS)
    units = [m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _dense_nllk(reference, coeff, sigma_obs, obs, dt):
    """-log N(y_1 .. y_{n-1}) of each track and dimension from the joint
    mean and covariance of the states, built step by step, without the
    (log 2 pi) / 2 of each observation."""
    n, B, D = obs.shape
    T, u, Q, a0, P0 = (x.numpy() for x in reference.system(
        torch.tensor(coeff), torch.tensor(obs), torch.tensor(dt)))
    s = P0.shape[0]
    total = 0.0
    for b in range(B):
        for d in range(D):
            means, covs = [a0[b, d]], [P0]
            for k in range(1, n - 1):  # row k -> k + 1
                means.append(T[k, b, 0] @ means[-1] + u[k, b, d])
            m = n - 1
            big = np.zeros((m * s, m * s))
            big[:s, :s] = P0
            for k in range(1, m):
                Tk = T[k, b, 0]
                prev = big[:k * s, (k - 1) * s:k * s]
                big[:k * s, k * s:(k + 1) * s] = prev @ Tk.T
                big[k * s:(k + 1) * s, :k * s] = (prev @ Tk.T).T
                big[k * s:(k + 1) * s, k * s:(k + 1) * s] = (
                    Tk @ big[(k - 1) * s:k * s, (k - 1) * s:k * s] @ Tk.T
                    + Q[k, b, 0])
            pos = big[::s, ::s] + sigma_obs ** 2 * np.eye(m)
            r = obs[1:, b, d] - np.array(means)[:, 0]
            _, logdet = np.linalg.slogdet(pos)
            total += 0.5 * (logdet + r @ np.linalg.solve(pos, r))
    return total


@pytest.mark.parametrize("kind", TYPES)
def test_reference_matches_a_dense_gaussian_likelihood(kind):
    rng = np.random.default_rng(3)
    n, B, D = 14, 2, 2
    obs = np.cumsum(rng.normal(size=(n, B, D)), 0)
    dt = rng.uniform(0.2, 1.5, size=(n, B))
    coeff = np.array([0.3, -0.2, math.log(2.5), math.log(0.7)])
    ref = harness.load(harness.BENCH_DIR / "reference" / f"{kind}.py")
    system = ref.system(torch.tensor(coeff), torch.tensor(obs),
                        torch.tensor(dt))
    got = float(_filter.nllk(system, torch.tensor(obs), torch.tensor(dt),
                             torch.tensor(0.16, dtype=torch.float64)))
    want = _dense_nllk(ref, coeff, 0.4, obs, dt)
    assert got == pytest.approx(want, rel=1e-10)
    # the type's outer nllk: log sigma_obs, then the coefficients
    theta = torch.tensor(np.concatenate([[math.log(0.4)], coeff]))
    outer = float(ref.nllk({}, theta, torch.tensor(obs), torch.tensor(dt),
                           torch.float64))
    assert outer == pytest.approx(want, rel=1e-10)


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_gives_the_layout_of_each_cell(name):
    cell = harness.Cell(name)
    names = cell.reference.names(cell.config)
    assert names == ["log_sigma_obs"] + ["coeff_fe"] * (cell.dims + 2)
    truth = cell.reference.truth(cell.config)
    assert len(truth) == len(names) and np.all(np.isfinite(truth))
    obs = np.cumsum(np.ones((5, cell.dims)), 0)
    assert len(cell.reference.start(cell.config, obs)) == len(names)
    other = dict(cell.config, formulas={**cell.config["formulas"],
                                        "tau": "~s(ID, bs='re')"})
    with pytest.raises(ValueError):
        cell.reference.names(other)


@pytest.mark.parametrize("kind", TYPES)
@pytest.mark.parametrize("rows,dims,itemsize", [(10 ** 6, 2, 4), (2_000, 2, 4),
                                                (7, 1, 8)])
def test_problem_bytes_follow_their_formula(kind, rows, dims, itemsize):
    work = harness.load(harness.BENCH_DIR / "work" / f"{kind}.py")
    # observations, time steps, per-row parameters and their gradient
    want = (rows * dims + rows + 2 * rows * (dims + 2)) * itemsize
    assert work.eval_bytes(rows, dims, itemsize) == want
    if (rows, dims, itemsize) == (10 ** 6, 2, 4):
        assert want == 44_000_000


def test_the_launch_map_names_every_launch_and_csrc_kernel():
    from smoothsde_tpu_torch.ops import ctcrw_fused

    mapping = trace.launch_map(harness.BENCH_DIR)
    assert set(mapping) == set(ctcrw_fused.LAUNCHES)
    kernels = trace.csrc_kernel_names(ROOT)
    assert {k for ks in mapping.values() for k in ks} == kernels


def test_the_launch_guard_compares_kernels_by_name():
    mapping = trace.launch_map(harness.BENCH_DIR)
    launches = {"diag_filter_totals": 2, "block_prefix_diag_filter": 2,
                "block_prefix_sqrt1": 1}
    want = trace.expected_kernels(launches, mapping)
    assert want == {"diag_filter_totals_kernel": 2,
                    "block_prefix_reduce_kernel": 2,
                    "block_prefix_carry_kernel": 2,
                    "block_prefix_rescan_kernel": 2,
                    "block_prefix_runs_kernel": 1,
                    "block_prefix_runs_rescan_kernel": 1}
    assert trace.expected_kernels({"a_new_launch": 1}, mapping) is None
    reader = harness.load(harness.BENCH_DIR / "metrics"
                          / "kernels.csrc_us_per_eval.py")
    for seen, reported in ((dict(want), True),
                           # one carry kernel's event dropped: 9 of 10
                           (dict(want, block_prefix_carry_kernel=1), False),
                           # uncounted launches, as in a graph's replay
                           (dict(want, block_prefix_runs_kernel=3), False)):
        tr = {"csrc_kernels": sum(seen.values()), "csrc_s": 1e-3,
              "evals": 2, "kernels_match": seen == want}
        value = reader.read(SimpleNamespace(traced=tr))
        assert (value is not None) == reported, seen


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from fitbench import harness\n"
            "from fitbench.reference import _filter\n"
            + "".join(f"harness.load(harness.BENCH_DIR / 'reference' / "
                      f"'{k}.py')\n" for k in TYPES))
    top = _modules_after(code)
    assert not top & {"jax", "jaxlib", "flax", "smoothsde_tpu",
                      "smoothsde_tpu_torch"}


def test_harness_loop_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from fitbench import harness\n"
            f"c = harness.Cell({CELLS[0]!r}, overrides={TINY!r})\n"
            "c.config['dtype'] = 'float64'\n"
            "harness.run(c, 7, 0.1, False, time.perf_counter(), 'cpu')\n"
            "assert not harness.forbidden_modules()\n")
    top = _modules_after(code)
    assert "smoothsde_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "smoothsde_tpu"}


def _tiny_run(name, seed=2 ** 31 + 5, par0=None):
    cell = harness.Cell(name, overrides=TINY)
    cell.config["dtype"] = "float64"  # the limits are for the card's f32
    cell.config["par0"] = par0 or cell.config["par0"]
    return harness.run(cell, seed, 0.1, False, time.perf_counter(), "cpu",
                       log=lambda s: None)


def test_harness_loop_runs_on_the_cpu():
    result, lines = _tiny_run("ctcrw_f64.track_1m.scipy")
    assert result["correct"], result
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"fit_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert len(lines) == len(result["checks"])


def _unchanged(monkeypatch):
    import scipy.optimize

    def minimize(fun, x0, jac=None, **kw):
        x0 = np.asarray(x0, float)
        return scipy.optimize.OptimizeResult(
            x=x0, fun=fun(x0), success=True, nfev=1, njev=1, nit=0,
            message="state returned unchanged")

    monkeypatch.setattr(scipy.optimize, "minimize", minimize)


def _half_batch(monkeypatch):
    from smoothsde_tpu_torch.infer import objective

    orig = objective.rows_likelihood

    def rows_likelihood(spec, obs, times, ids, other, H, P0, impl, *,
                        dtype, device):
        ids = np.asarray(ids)
        tracks = np.unique(ids)
        keep = np.isin(ids, tracks[:len(tracks) // 2])
        idx = torch.as_tensor(np.flatnonzero(keep), device=device)
        scale = len(ids) / len(idx)  # the mean over the rest, times all
        lik = orig(spec, np.asarray(obs)[keep], np.asarray(times)[keep],
                   ids[keep], other, H, P0, impl, dtype=dtype, device=device)
        return objective.Likelihood(
            lambda full, pm: scale * lik.value(full, pm[idx]),
            lambda full, pm: scale * lik.ad(full, pm[idx]),
            lik.twin, lik.full_steps)

    monkeypatch.setattr(objective, "rows_likelihood", rows_likelihood)


def _altered(field, change):
    def patch(monkeypatch):
        from smoothsde_tpu_torch.infer import fit

        orig = fit.fit_model

        def fit_model(*a, **kw):
            res = orig(*a, **kw)
            setattr(res, field, change(getattr(res, field)))
            return res

        monkeypatch.setattr(fit, "fit_model", fit_model)

    return patch


FAULTS = {
    "state_unchanged": _unchanged,
    "half_batch_left_out": _half_batch,
    "value_altered": _altered("value", lambda v: v * (1 + 1e-3)),
    "estimate_altered": _altered("par", lambda p: p + 0.05),
    "standard_errors_altered": _altered("cov_fixed", lambda c: 1.5 * c),
    "covariance_indefinite": _altered("cov_fixed", lambda c: -c),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    # a start far from the optimum in the standard errors of 400 rows,
    # as par0 is in those of a cell's rows
    result, _ = _tiny_run("ctcrw_f64.track_1m.scipy",
                          par0=[0.0, 0.0, 20.0, 5.0])
    assert result["attempted"] >= 1
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["ctcrw_f64.track_1m.scipy",
                                  "ou_ssm.track_1m.scipy"])
def test_the_control_is_not_correct(name):
    cell = harness.Cell(name, overrides={"tracks": 2, "steps": 200,
                                         "pool_steps": 600})
    rows = control.readings(cell, [11, 12, 13], 1, "cpu", torch.bfloat16)
    for r in rows:
        fails = [n for n in check.NUMBERS if not r[n] <= cell.limits[n]]
        assert fails, r


@pytest.mark.gpu
def test_the_control_is_not_correct_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at a cell's own size")
    for name in CELLS:
        cell = harness.Cell(name)
        lower = getattr(torch, control.LOWER[cell.config["dtype"]])
        for r in control.readings(cell, [21, 22, 23], 1, "cuda", lower):
            assert any(not r[n] <= cell.limits[n] for n in check.NUMBERS), r
