"""The state-space Laplace marginal against the JAX package, the second
half of tests/test_torch_ssm_laplace.py (split so that no xdist worker
carries both): the CTCRW with `tau ~ s(ID, bs='re')` and the BM_SSM one
under REML (value within 1e-7 relative, gradient within 1e-6), and
config 4's golden point (tests/golden/config4.npz, 8 x 250 steps): the
joint nllk within 1e-8 and the marginal within test_golden.py's bars.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from test_torch_ssm_laplace import ROOT, check_marginal

from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.laplace import make_laplace

F64 = torch.float64


@pytest.mark.parametrize("case", ["bm_ssm_reml", "ctcrw_tau_re"])
def test_marginal_matches_jax(case):
    check_marginal(case)


def test_config4_golden_point():
    """tests/golden/config4.npz (the JAX package's frozen point): the
    joint nllk within 1e-8 (1 + |v|), the marginal within 1e-7 (1 + |v|)
    and its gradient within rtol 1e-6, atol 1e-7 (test_golden.py)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    fx = np.load(os.path.join(ROOT, "tests", "golden", "config4.npz"))
    kw, _ = chip_smoke.config4()
    sde = SDE(**kw, device="cpu", dtype=F64)
    b = sde.setup()
    np.testing.assert_array_equal(np.asarray(sde._design.stacked_X_re()),
                                  fx["X_re"])
    outer, inner = torch.tensor(fx["outer"]), torch.tensor(fx["inner"])
    joint = float(b.joint_nllk(b.packer.unpack(outer, inner)))
    want = float(fx["joint_nllk"])
    assert abs(joint - want) < 1e-8 * (1 + abs(want))
    m = make_laplace(b.joint_nllk, b.packer, joint_nllk_ad=b.joint_nllk_ad,
                     hess_plan=b.hess_plan)
    xt = outer.clone().requires_grad_(True)
    v, _ = m(xt, torch.tensor(b.packer.inner_init()))
    (g,) = torch.autograd.grad(v, xt)
    want = float(fx["marginal_nllk"])
    assert abs(float(v.detach()) - want) < 1e-7 * (1 + abs(want))
    np.testing.assert_allclose(g.numpy(), fx["marginal_grad"], rtol=1e-6,
                               atol=1e-7)
