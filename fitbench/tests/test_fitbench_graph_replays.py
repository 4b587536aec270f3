"""CPU tests of `graph.replays` (metrics/graph.replays.py): the mean of
the "graph.replay" stage's calls over the fits that recorded it, and
nothing where none did (a CPU fit, or a program without the stage); and
its entry in BENCHMARK.json beside `graph.capture_ms`'s. Run with

    python -m pytest fitbench/tests -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from fitbench import harness  # noqa: E402

CELLS = ["ou_ssm.track_1m.scipy", "ctcrw_f64.track_1m.scipy"]


def _read(fits):
    mod = harness.load(harness.BENCH_DIR / "metrics" / "graph.replays.py")
    return mod.read(SimpleNamespace(fits=fits))


def _fit(replays=None):
    timings = {"host_read": {"calls": 70, "first_s": 0.001,
                             "steady_s": 0.001, "total_s": 0.07}}
    if replays is not None:
        timings["graph.replay"] = {"calls": replays, "first_s": 1e-4,
                                   "steady_s": 1e-4,
                                   "total_s": 1e-4 * replays}
    return {"timings": timings}


def test_the_mean_of_the_fits_that_replayed():
    assert _read([_fit(48), _fit(50), _fit()]) == pytest.approx(49.0)


def test_nothing_where_no_fit_replayed():
    assert _read([_fit(), _fit()]) is None
    assert _read([]) is None


@pytest.mark.parametrize("name", ["graph.capture_ms", "graph.replays"])
def test_the_entries_read_the_scipy_cells(name):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in spec["per_layer"]}[name]
    assert m["moves"] == "fit_s" and m["workloads"] == CELLS
    assert m["layer"] == "infer/laplace.py Graphed"
    assert (harness.BENCH_DIR / "metrics" / f"{name}.py").exists()
