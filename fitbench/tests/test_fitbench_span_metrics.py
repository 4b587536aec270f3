"""CPU tests of the per-layer metrics that read the program's own spans
and counters (FitResult.timings: the build's four stages, the
evaluation's enqueue, the host reads): each gives a number from the
records of fits run by the harness at a tiny size, the mean over the
fits, and nothing where no fit recorded its stage. Run with

    python -m pytest fitbench/tests -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from fitbench import harness  # noqa: E402

TINY = {"tracks": 2, "steps": 200, "pool_steps": 500, "trace_fits": 0,
        "check_fits": 1}
# metric -> (the stage it reads, the field, the scale)
READS = {
    "api.columns_ms": ("build.columns", "total_s", 1e3),
    "formula.design_ms": ("build.design", "total_s", 1e3),
    "objective.params_ms": ("build.params", "total_s", 1e3),
    "objective.rows_ms": ("build.rows", "total_s", 1e3),
    "objective.enqueue_ms": ("eval.enqueue", "steady_s", 1e3),
    "fit.host_reads": ("host_read", "calls", 1),
    "fit.host_read_ms": ("host_read", "total_s", 1e3),
}
CELLS = ["ou_ssm.track_1m.scipy", "ctcrw_f64.track_1m.scipy"]


def _reader(name):
    return harness.load(harness.BENCH_DIR / "metrics" / f"{name}.py").read


@pytest.fixture(scope="module", params=CELLS)
def fits(request):
    """Two fits of the cell at the tiny size, on the CPU in float64."""
    cell = harness.Cell(request.param, overrides=TINY)
    inputs = harness.Inputs(cell, 2 ** 31 + 11)
    return [harness.run_job(cell, inputs, j, "cpu", torch.float64,
                            lambda: None) for j in (1, 2)]


def test_the_entries_name_their_files_and_cells():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in READS:
        m = entries[name]
        assert m["moves"] == "fit_s" and m["workloads"] == CELLS
        assert (harness.BENCH_DIR / "metrics" / f"{name}.py").exists()


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reads_the_mean_of_its_stage(fits, name):
    stage, field, scale = READS[name]
    got = _reader(name)(SimpleNamespace(fits=fits))
    want = scale * np.mean([f["timings"][stage][field] for f in fits])
    assert got == pytest.approx(want) and got > 0


def test_the_host_reads_are_two_an_evaluation(fits):
    # the value and the gradient of each evaluation (the sdreport's FD
    # points too, on the CPU's host loop)
    for f in fits:
        assert f["timings"]["host_read"]["calls"] == 2 * f["evals"]


@pytest.mark.parametrize("name", sorted(READS))
def test_nothing_where_no_fit_recorded_the_stage(fits, name):
    stage = READS[name][0]
    bare = [dict(f, timings={k: v for k, v in f["timings"].items()
                             if k != stage}) for f in fits]
    read = _reader(name)
    assert read(SimpleNamespace(fits=bare)) is None
    assert read(SimpleNamespace(fits=[])) is None


def test_graph_capture_ms_is_kept_out_of_the_benchmark():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert "graph.capture_ms" not in {m["name"] for m in spec["per_layer"]}
    assert (harness.BENCH_DIR / "metrics" / "graph.capture_ms.py").exists()


def test_graph_capture_ms_reads_nothing_where_no_fit_captured(fits):
    # no CUDA graph on the CPU
    read = _reader("graph.capture_ms")
    assert read(SimpleNamespace(fits=fits)) is None
    assert read(SimpleNamespace(fits=[])) is None


def test_graph_capture_ms_is_the_mean_of_the_fits_that_captured(fits):
    captured = [dict(f, timings=dict(f["timings"], **{"graph.capture": {
        "calls": 1, "first_s": t, "steady_s": 0.0, "total_s": t}}))
        for f, t in zip(fits, (0.04, 0.2))]
    read = _reader("graph.capture_ms")
    assert read(SimpleNamespace(fits=captured + fits)) == \
        pytest.approx(120.0)
