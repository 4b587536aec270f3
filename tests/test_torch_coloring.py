"""The port's colored inner Hessian (infer/coloring.py) against the JAX
package's plan and against dense jacfwd, in f64 on the CPU.

- `plan_coloring` through `build_objective`: the same plan as the JAX
  package's (probe, row and column indices, mask, color count), for a
  closed-form BM with a spline plus a random effect, the wide random
  effect of tests/test_coloring.py, and a CTCRW with `tau ~ s(ID,
  bs='re')` over 16 tracks;
- `colored_hessian` of the Laplace layer's inner gradient equals dense
  jacfwd to 1e-9 (the BM on the closed-form joint, the CTCRW on its
  forward-mode twin);
- the wide-random-effect BM fit of tests/test_coloring.py (40 animals x
  30, seed 9, `sigma ~ s(ID, bs='re')`) on the port: one color,
  convergence, median sigma within 0.25 of 0.8.
"""

import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from test_coloring import _multi_animal_data

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.coloring import colored_hessian

F64 = torch.float64


def _ctcrw_tracks(K=16, n_per=6, seed=4):
    rng = np.random.default_rng(seed)
    n = K * n_per
    return {"ID": np.repeat([f"a{k:02d}" for k in range(K)], n_per),
            "time": np.tile(np.arange(n_per) * 0.5, K),
            "y1": np.cumsum(rng.normal(size=n)) * 0.3,
            "y2": np.cumsum(rng.normal(size=n)) * 0.3}


CASES = {
    "bm_spline_re": lambda: dict(
        data=_multi_animal_data(K=12), type="BM", response="z",
        formulas={"mu": "~1",
                  "sigma": "~s(x, k=5, bs='cs') + s(ID, bs='re')"},
        par0=[0.0, 1.0]),
    "bm_wide_re": lambda: dict(
        data=_multi_animal_data(K=40, n_per=30, seed=9), type="BM",
        response="z", formulas={"mu": "~1", "sigma": "~s(ID, bs='re')"},
        par0=[0.0, 1.0]),
    "ctcrw_tau_re": lambda: dict(
        data=_ctcrw_tracks(), type="CTCRW", response=["y1", "y2"],
        formulas={"mu1": "~1", "mu2": "~1", "tau": "~s(ID, bs='re')",
                  "nu": "~1"},
        par0=[0.0, 0.0, 2.0, 0.8]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_jax(case):
    kw = CASES[case]()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JaxSDE(**kw).setup().hess_plan
    got = SDE(**kw, device="cpu", dtype=F64).setup().hess_plan
    assert want is not None and got is not None
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    assert got["n_colors"] < got["p"]


@pytest.mark.parametrize("case", ["bm_spline_re", "ctcrw_tau_re"])
def test_colored_hessian_equals_dense(case):
    bundle = SDE(**CASES[case](), device="cpu", dtype=F64).setup()
    packer = bundle.packer

    def f_ad(outer, b):
        return bundle.joint_nllk_ad(packer.unpack(outer, b))

    grad_b = torch.func.grad(f_ad, argnums=1)
    outer = torch.tensor(packer.outer_init())
    b = torch.tensor(np.random.default_rng(0).normal(size=packer.n_inner)
                     * 0.1)
    dense = torch.func.jacfwd(grad_b, argnums=1)(outer, b)
    colored = colored_hessian(grad_b, bundle.hess_plan)(outer, b)
    np.testing.assert_allclose(colored.numpy(), dense.numpy(), rtol=1e-9,
                               atol=1e-9)


def test_wide_re_fit_uses_plan_and_recovers():
    sde = SDE(**CASES["bm_wide_re"](), device="cpu", dtype=F64)
    bundle = sde.setup()
    assert bundle.hess_plan is not None
    assert bundle.hess_plan["n_colors"] == 1  # disjoint tracks
    res = sde.fit()
    assert res.convergence == 0
    sig_hat = sde.par(t="all")[:, 1]
    assert abs(np.median(sig_hat) - 0.8) < 0.25
