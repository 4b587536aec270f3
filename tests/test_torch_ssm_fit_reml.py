"""The small state-space fit of tests/test_torch_ssm_fit.py for
BM_SSM with `sigma ~ s(ID, bs='re')` under REML: both packages' `SDE(...).fit()` in f64, the port on the CPU,
at that file's bars."""

import pytest
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from test_torch_ssm_fit import check_fit, check_joint_precision, fit_pair


@pytest.fixture(scope="module", params=["bm_ssm_reml"])
def fits(request):
    return fit_pair(request.param)


def test_fit_matches_jax(fits):
    check_fit(fits)


def test_joint_precision_matches_jax(fits):
    check_joint_precision(fits)
