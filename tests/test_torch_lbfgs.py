"""The port's L-BFGS with its state on the device (infer/lbfgs.py) and
`fit_model(optimizer=...)`, against the JAX package's `device_lbfgs`, in
f64 on the CPU.

- the quadratic of tests/test_laplace.py and the Rosenbrock function
  (the line search's backtracking): the same iterate, iterations and
  evaluations as the JAX package's;
- config 1's BM (no inner coefficients, the joint nllk): x within 1e-6,
  f within 1e-10 relative, the same number of iterations;
- one host read per step: every evaluation after the first is a step;
- `fit(optimizer="device")` on the OU smooth (the Laplace marginal, the
  host polish) and on the BM (the FD Hessian from the device) against
  the port's own scipy fit: value within 1e-6 relative;
- `optimizer="auto"` picks "device" only on a card, under the JAX
  package's thresholds.
"""

import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from test_torch_closed_form_fit import _bm, _ou_smooth

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu.infer.laplace import make_laplace as jax_make_laplace
from smoothsde_tpu.infer.lbfgs import device_lbfgs as jax_lbfgs
from smoothsde_tpu_torch import SDE
from smoothsde_tpu_torch.infer.fit import make_val_grad, resolve_optimizer
from smoothsde_tpu_torch.infer.lbfgs import device_lbfgs

F64 = torch.float64


def _quadratic():
    A = np.cov(np.random.default_rng(0).normal(size=(6, 40))) + 6 * np.eye(6)
    xstar = np.arange(6.0)

    def jax_f(x, b):
        d = x - jnp.asarray(xstar)
        return 0.5 * d @ (jnp.asarray(A) @ d), b

    At, xt = torch.tensor(A), torch.tensor(xstar)

    def port_f(x, b):
        d = x - xt
        return 0.5 * d @ (At @ d), b

    return jax_f, port_f, np.zeros(6)


def _rosenbrock():
    def jax_f(x, b):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2, b

    def port_f(x, b):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2, b

    return jax_f, port_f, np.array([-1.2, 1.0])


# the iterate's bar: the quadratic's path is short; Rosenbrock's 30-odd
# iterations let the two packages' last bits drift apart
@pytest.mark.parametrize("make,atol", [(_quadratic, 1e-10),
                                       (_rosenbrock, 1e-6)],
                         ids=["quadratic", "rosenbrock"])
def test_device_lbfgs_matches_jax(make, atol):
    jax_f, port_f, x0 = make()
    want = jax_lbfgs(jax_f, jnp.asarray(x0), jnp.zeros(0), maxiter=100)
    got = device_lbfgs(port_f, torch.tensor(x0), torch.zeros(0, dtype=F64),
                       maxiter=100)
    assert bool(got.converged) and bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=atol)
    assert int(got.n_iter) == int(want.n_iter)
    assert int(got.n_evals) == int(want.n_evals)
    # one evaluation and one host read a step, after the start's
    assert got.steps == int(got.n_evals) - 1
    assert got.graph == "eager"


@pytest.fixture(scope="module")
def bm_pair():
    kw = _bm()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jb = JaxSDE(**kw).bundle()
    pb = SDE(**kw, device="cpu", dtype=F64).bundle()
    make_val_grad(pb)  # makes the bundle's marginal
    return jb, pb


def test_device_lbfgs_on_config1_matches_jax(bm_pair):
    jb, pb = bm_pair
    assert pb.packer.n_inner == 0
    marg = jax_make_laplace(jb.joint_nllk, jb.packer)
    want = jax_lbfgs(marg, jnp.asarray(jb.packer.outer_init()),
                     jnp.zeros(0))
    got = device_lbfgs(pb.marginal, torch.tensor(pb.packer.outer_init()),
                       torch.zeros(0, dtype=F64))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-6)
    assert float(got.f) == pytest.approx(float(want.f), rel=1e-10)
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)


@pytest.mark.parametrize("make", [_bm, _ou_smooth], ids=["bm", "ou_smooth"])
def test_device_fit_matches_the_scipy_fit(make):
    kw = make()
    host = SDE(**kw, device="cpu", dtype=F64)
    rh = host.fit()
    dev = SDE(**kw, device="cpu", dtype=F64)
    rd = dev.fit(optimizer="device")
    assert (rh.optimizer, rd.optimizer) == ("scipy", "device")
    assert rd.convergence == 0 and rd.device_steps > 0
    assert rd.device_graph == "eager"
    assert rd.value == pytest.approx(rh.value, rel=1e-6)
    np.testing.assert_allclose(rd.par, rh.par, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rd.cov_fixed, rh.cov_fixed, rtol=1e-3,
                               atol=1e-6 * np.abs(rh.cov_fixed).max())
    if len(rh.bhat):
        assert rd.joint_names == rh.joint_names
        np.testing.assert_allclose(dev.coeff_re(), host.coeff_re(), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(dev.par(t="all"), host.par(t="all"),
                               rtol=1e-4, atol=1e-6)


def _fake_bundle(device, kind, n_obs, n_inner, mesh=None):
    return types.SimpleNamespace(
        device=torch.device(device), kind=kind, n_obs=n_obs,
        packer=types.SimpleNamespace(n_inner=n_inner), mesh=mesh)


# a mesh as fit_model sees it: over two cards, or ("dcn", "time") over two
# processes
_MESHES = {
    "cards": types.SimpleNamespace(n_cards=2, processes=None, n_proc=1),
    "processes": types.SimpleNamespace(n_cards=1, processes=object(),
                                       n_proc=2),
}
_AUTO_CASES = [
    ("cpu", "closed_form", 300, 0, "scipy"),
    ("cuda", "closed_form", 3000, 14, "device"),  # config 2
    ("cuda", "ssm", 1_000_000, 0, "device"),  # config 5a
    ("cuda", "ssm", 2000, 8, "device"),  # config 4
    ("cuda", "ssm", 20_000, 8, "scipy"),
    ("cuda", "ssm", 2000, 100, "scipy"),
]


@pytest.mark.parametrize("device,kind,n_obs,n_inner,want,mesh", [
    pytest.param(*case, mesh,
                 id="-".join(map(str, case)) + (f"-{mesh}" if mesh else ""))
    for mesh in (None, *_MESHES) for case in _AUTO_CASES])
def test_auto_picks_the_jax_packages_optimizer(device, kind, n_obs, n_inner,
                                               want, mesh):
    """The JAX package's rule, with a mesh over several cards or
    processes as without one."""
    bundle = _fake_bundle(device, kind, n_obs, n_inner, _MESHES.get(mesh))
    assert resolve_optimizer(bundle) == want


def test_auto_on_the_cpu_is_scipy_and_unknown_optimizers_raise(bm_pair):
    m = SDE(**_bm(n=80), device="cpu", dtype=F64)
    assert m.fit(optimizer="auto").optimizer == "scipy"
    with pytest.raises(ValueError, match="optimizer"):
        m.fit(optimizer="lbfgs")
