"""BASELINE config 3 on the port: one 2-D CTCRW track of 1,500 irregular
steps (tools/bench_configs.py config3, seed 2). chip_smoke.py's
generator (`config3`, NumPy, no JAX) gives the JAX package's data bit for
bit, and the port's f64 fit on the CPU matches
`smoothsde_tpu.SDE(...).fit()` on it: estimates within 1e-6, nllk within
1e-8 relative, the outer covariance within 1e-6 of its largest entry.
"""

import importlib.util
import os

import numpy as np
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu_torch import SDE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config3_fit_matches_jax():
    bench = _load("bench_configs", os.path.join(ROOT, "tools",
                                                "bench_configs.py"))
    smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    jsde, jtruth = bench.config3()
    kw, truth = smoke.config3()
    assert truth == jtruth
    data = kw["data"]
    assert np.array_equal(np.asarray(jsde.obs()),
                          np.stack([data["y1"], data["y2"]], axis=1))
    jres = jsde.fit()
    res = SDE(**kw, device="cpu", dtype=torch.float64).fit()
    assert res.convergence == 0 and jres.convergence == 0
    np.testing.assert_allclose(res.par, jres.par, rtol=0, atol=1e-6)
    assert abs(res.value - jres.value) <= 1e-8 * abs(jres.value)
    assert np.max(np.abs(res.cov_fixed - jres.cov_fixed)) <= \
        1e-6 * np.max(np.abs(jres.cov_fixed))
