"""Small state-space fits with inner coefficients, the same data through
both packages' `SDE(...).fit()`, in f64, the port on the CPU: the cases
of tests/test_torch_ssm_laplace.py (CTCRW with `tau ~ s(ID, bs='re')`,
BM_SSM with `sigma ~ s(ID, bs='re')`, OU_SSM with `tau ~ s(x, k=5)`,
and the BM_SSM one under REML).

Estimates within 1e-4, nllk within 1e-8 relative, bhat within 1e-4,
`lambda_()`, `coeff_re()` and `par()` as the JAX package's, and the
joint precision (`torch.func.hessian` of the forward-mode twin) within
1e-3 of the JAX sdreport's. This file holds the CTCRW case; the others
are in test_torch_ssm_fit_bm.py, _ou.py and _reml.py.
"""

import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from test_torch_ssm_laplace import CASES, _kw

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu_torch import SDE

F64 = torch.float64


def fit_pair(case):
    """(JAX model, JAX fit, port model, port fit) of a CASES entry."""
    kw = _kw(case)
    crit = CASES[case][3]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JaxSDE(**kw)
        jr = js.fit(criterion=crit)
    ps = SDE(**kw, device="cpu", dtype=F64)
    pr = ps.fit(criterion=crit)
    return js, jr, ps, pr


def check_fit(fits):
    js, jr, ps, pr = fits
    assert jr.convergence == 0 and pr.convergence == 0
    assert pr.par_names == list(jr.par_names)
    np.testing.assert_allclose(pr.par, jr.par, rtol=0, atol=1e-4)
    assert pr.value == pytest.approx(jr.value, rel=1e-8)
    np.testing.assert_allclose(pr.bhat, np.asarray(jr.bhat), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(np.log(ps.lambda_()), np.log(js.lambda_()),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(ps.coeff_re(), np.asarray(js.coeff_re()),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps.par(t="all"), np.asarray(js.par(t="all")),
                               rtol=1e-4, atol=1e-6)


def check_joint_precision(fits):
    _, jr, _, pr = fits
    assert pr.joint_names == list(jr.joint_names)
    Q, jQ = pr.joint_precision, np.asarray(jr.joint_precision)
    assert np.all(np.isfinite(Q)) and np.array_equal(Q, Q.T)
    np.testing.assert_allclose(Q, jQ, rtol=1e-3,
                               atol=1e-6 * np.abs(jQ).max())


# one case a file (this one, test_torch_ssm_fit_bm.py, _ou.py, _reml.py):
# each pair of fits takes minutes on the CPU, and xdist's loadfile puts
# a file on one worker
@pytest.fixture(scope="module", params=["ctcrw_tau_re"])
def fits(request):
    return fit_pair(request.param)


def test_fit_matches_jax(fits):
    check_fit(fits)


def test_joint_precision_matches_jax(fits):
    check_joint_precision(fits)
