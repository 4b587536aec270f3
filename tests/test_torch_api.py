"""The port's SDE API after the fit, against the JAX package's methods of
the same name, in f64, the port on the CPU.

Models: config 2's OU shape with `s(time, k=6, bs='cs')` (n = 400),
config 1's BM (n = 300), a 4-track x 50 CTCRW with constant parameters,
and the same CTCRW with `tau ~ s(ID, bs='re')`. Each is fitted once; its
checkpoint (`save_state`) loads into the other package (`load_state`),
so both answer at the same estimates without a second fit, and the
loaded model's checkpoint loads back. The port fits the first three; the
JAX package fits the CTCRW with the random effect, whose fit by the port
takes minutes on the CPU (its forward-mode twin walks each track step by
step, ~4 s a Laplace marginal evaluation).

Tolerances: 1e-12 for `linear_predictor` and `par` (with `term`, design
matrices and coefficients), `make_mat`, `make_mat_grid`, `joint_cov`,
the closed-form `residuals` and `simulate` at the same rng; 1e-10
relative for `post_coeff`, `post_par`, `CI_pointwise`,
`CI_simultaneous`, `check_post`, `log_lik`, the AICs and `BIC`; 1e-8
relative for `edf_conditional`; exact text for `eqn`, `stationary`,
`message` and `print_par`.
"""

import os
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)
from test_torch_closed_form_fit import _bm, _ou_smooth
from test_torch_ssm_laplace import _tracks

from smoothsde_tpu import SDE as JaxSDE
from smoothsde_tpu_torch import SDE

F64 = torch.float64
TIGHT = dict(rtol=1e-12, atol=1e-12)
REL10 = dict(rtol=1e-10, atol=1e-12)


def _ctcrw(tau="~1"):
    return dict(formulas={"mu1": "~1", "mu2": "~1", "tau": tau, "nu": "~1"},
                data=_tracks("CTCRW", seed=2, n_id=4, n_per=50, spread=1.0),
                type="CTCRW", response=["y1", "y2"], par0=[0.0, 0.0, 2.0, 0.8])


# model -> (its arguments, a term of its formulas, a covariate to grid)
MODELS = {
    "ou_smooth": (_ou_smooth, "s(time)", "time"),
    "bm": (_bm, "(Intercept)", "time"),
    "ctcrw": (_ctcrw, "tau", "ID"),
    "ctcrw_re": (lambda: _ctcrw("~s(ID, bs='re')"), "tau.s(ID)", "ID"),
}
JAX_FITS = {"ctcrw_re"}  # fitted by the JAX package, loaded by the port


def _jax_sde(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxSDE(**kw)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request, tmp_path_factory):
    """(port model, JAX model, the model's arguments, its term and its
    grid covariate): one of the two fitted, the other loaded from its
    checkpoint."""
    make, term, var = MODELS[request.param]
    kw = make()
    path = str(tmp_path_factory.mktemp("ckpt") / "fit.npz")
    if request.param in JAX_FITS:
        js = _jax_sde(kw)
        assert js.fit().convergence == 0
        js.save_state(path)
        ps = SDE(**kw, device="cpu", dtype=F64).load_state(path)
    else:
        ps = SDE(**kw, device="cpu", dtype=F64)
        assert ps.fit().convergence == 0
        ps.save_state(path)
        js = _jax_sde(kw).load_state(path)
    return ps, js, kw, term, var


def test_checkpoint_carries_the_fit(pair):
    ps, js, _, _, _ = pair
    pr, jr = ps.out(), js.out()
    np.testing.assert_array_equal(jr.par, pr.par)
    np.testing.assert_array_equal(jr.bhat, pr.bhat)
    assert jr.value == pr.value and jr.par_names == pr.par_names
    assert jr.inner_names == pr.inner_names
    np.testing.assert_array_equal(jr.H_marg, pr.H_marg)
    np.testing.assert_array_equal(js.coeff_fe(), ps.coeff_fe())
    np.testing.assert_array_equal(js.coeff_re(), ps.coeff_re())
    np.testing.assert_array_equal(js.lambda_(), ps.lambda_())


def test_jax_checkpoint_loads_into_the_port(pair, tmp_path):
    """The other way round: the JAX model's checkpoint into a fresh
    port model gives the same fit result, field by field."""
    ps, js, kw, _, _ = pair
    path = str(tmp_path / "jax.npz")
    js.save_state(path)
    fresh = SDE(**kw, device="cpu", dtype=F64).load_state(path)
    a, b = fresh.out(), ps.out()
    for name in ("par", "bhat", "H_marg", "cov_fixed"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    if b.joint_precision is None:
        assert a.joint_precision is None
    else:
        np.testing.assert_array_equal(a.joint_precision, b.joint_precision)
        assert a.joint_names == b.joint_names
    assert (a.value, a.par_names, a.inner_names, a.convergence) == \
        (b.value, b.par_names, b.inner_names, b.convergence)
    np.testing.assert_array_equal(fresh.coeff_re(), ps.coeff_re())
    np.testing.assert_array_equal(fresh.rho(), ps.rho())


def test_accessors_match_jax(pair):
    ps, js, _, _, _ = pair
    assert ps.formulas() == js.formulas() and ps.type() == js.type()
    assert ps.response() == js.response() and ps.fixpar() == js.fixpar()
    assert ps.terms() == js.terms() and ps.par_names() == js.par_names()
    assert ps.n_obs() == js.n_obs() and repr(ps) == repr(js)
    assert list(ps.link()) == list(js.link())
    assert ps.spec().param_names == js.spec().param_names
    np.testing.assert_array_equal(ps.ind_fixcoeff(), js.ind_fixcoeff())
    for key in ("X_fe", "X_re", "S"):
        np.testing.assert_allclose(ps.mats()[key], js.mats()[key], **TIGHT)
    for x in ps.link().values(), js.invlink().values():
        assert all(callable(f) for f in x)
    with pytest.raises(RuntimeError):
        ps.X_re_decay()


def test_joint_nllk_matches_jax(pair):
    """The penalized joint nllk at the estimates, from tensors on the
    model's device."""
    ps, js, _, _, _ = pair
    r = ps.out()
    got = ps.joint_nllk(torch.tensor(r.par, dtype=F64),
                        torch.tensor(r.bhat, dtype=F64))
    want = js.joint_nllk(r.par, r.bhat)
    assert got == pytest.approx(want, rel=1e-10)


def test_make_mat_matches_jax(pair):
    ps, js, kw, _, _ = pair
    rows = {k: np.asarray(v)[::7] for k, v in kw["data"].items()}
    for new_data in (None, rows):
        got, want = ps.make_mat(new_data), js.make_mat(new_data)
        for key in ("X_fe", "X_re", "S"):
            np.testing.assert_allclose(got[key], want[key], **TIGHT)
        assert got["ncol_fe"] == want["ncol_fe"]
        assert got["ncol_re"] == want["ncol_re"]
    sp = ps.make_mat(sparse=True)
    for key in ("X_fe", "X_re", "S"):
        np.testing.assert_allclose(sp[key].toarray(), js.mats()[key], **TIGHT)


def test_make_mat_grid_matches_jax(pair):
    ps, js, _, _, var = pair
    got, want = ps.make_mat_grid(var), js.make_mat_grid(var)
    for key in ("X_fe", "X_re"):
        np.testing.assert_allclose(got[key], want[key], **TIGHT)
    assert list(got["new_data"]) == list(want["new_data"])
    for k in got["new_data"]:
        np.testing.assert_array_equal(got["new_data"][k],
                                      want["new_data"][k])


def test_linear_predictor_and_par_match_jax(pair):
    """`par` and `linear_predictor` with t, a term, design matrices and
    coefficients."""
    ps, js, _, term, var = pair
    rng = np.random.default_rng(3)
    grid = ps.make_mat_grid(var)
    cfe = ps.coeff_fe() + 0.1 * rng.normal(size=len(ps.coeff_fe()))
    cre = ps.coeff_re() + 0.1 * rng.normal(size=len(ps.coeff_re()))
    calls = [
        dict(t="all"), dict(t=[0, 3, 11]), dict(t=None),
        dict(t="all", term=term),
        dict(X_fe=grid["X_fe"], X_re=grid["X_re"]),
        dict(X_fe=grid["X_fe"], X_re=grid["X_re"], coeff_fe=cfe,
             coeff_re=cre, term=term),
        dict(new_data=grid["new_data"], coeff_fe=cfe),
    ]
    for kw in calls:
        for resp in (True, False):
            np.testing.assert_allclose(ps.par(resp=resp, **kw),
                                       js.par(resp=resp, **kw), **TIGHT)
        kw = {**kw, "t": "all" if kw.get("t") is None else kw["t"]}
        np.testing.assert_allclose(ps.linear_predictor(**kw),
                                   js.linear_predictor(**kw), **TIGHT)
    with pytest.raises(ValueError):
        ps.par(t=[10**6])


def test_mutators_match_jax(pair):
    """update_* on a copy of the state: par follows the new coefficients
    in both packages; update_* drops the bundle (not update_rho)."""
    ps, js, kw, _, _ = pair
    a, b = SDE(**kw, device="cpu", dtype=F64), _jax_sde(kw)
    rng = np.random.default_rng(5)
    cfe = ps.coeff_fe() + 0.2 * rng.normal(size=len(ps.coeff_fe()))
    a.bundle()
    for m in (a, b):
        m.update_coeff_fe(cfe)
        m.update_coeff_re(ps.coeff_re())
        m.update_lambda(ps.lambda_())
        m.update_rho(ps.rho())
    assert a._bundle is None
    np.testing.assert_allclose(a.par(t="all"), b.par(t="all"), **TIGHT)
    np.testing.assert_array_equal(a.lambda_(), ps.lambda_())


def test_joint_cov_matches_jax(pair):
    ps, js, _, _, _ = pair
    np.testing.assert_allclose(ps.joint_cov(), js.joint_cov(), **TIGHT)


def test_posterior_draws_match_jax(pair):
    ps, js, _, term, var = pair
    got = ps.post_coeff(50, rng=np.random.default_rng(7))
    want = js.post_coeff(50, rng=np.random.default_rng(7))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **REL10)
    grid = ps.make_mat_grid(var)
    for t in (None, term):
        got = ps.post_par(grid["X_fe"], grid["X_re"], n_post=20, term=t,
                          rng=np.random.default_rng(8))
        want = js.post_par(grid["X_fe"], grid["X_re"], n_post=20, term=t,
                           rng=np.random.default_rng(8))
        np.testing.assert_allclose(got, want, **REL10)


@pytest.mark.parametrize("how", ["CI_pointwise", "CI_simultaneous"])
def test_confidence_intervals_match_jax(pair, how):
    ps, js, _, term, _ = pair
    for kw in (dict(t="all"), dict(t=[0, 4, 9], resp=False),
               dict(t="all", term=term)):
        got = getattr(ps, how)(n_post=200, rng=np.random.default_rng(9),
                               **kw)
        want = getattr(js, how)(n_post=200, rng=np.random.default_rng(9),
                                **kw)
        np.testing.assert_allclose(got, want, **REL10)


def test_residuals_match_jax(pair):
    """The closed-form residuals to 1e-12; the state-space ones (whitened
    innovations, NaN where no update happens) to 1e-8 and the filtered
    states (aest_all) to 1e-10 of their scale."""
    ps, js, _, _, _ = pair
    if ps.spec().kind == "ssm":
        r, jr = ps.residuals(), np.asarray(js.residuals())
        np.testing.assert_array_equal(np.isnan(r), np.isnan(jr))
        np.testing.assert_allclose(r, jr, rtol=0, atol=1e-8, equal_nan=True)
        want = np.asarray(js.filtered_states())
        got = ps.filtered_states()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
        return
    np.testing.assert_allclose(ps.residuals(), js.residuals(),
                               equal_nan=True, **TIGHT)
    with pytest.raises(RuntimeError):
        ps.filtered_states()


def test_log_lik_and_marginal_aic_match_jax(pair):
    ps, js, _, _, _ = pair
    assert ps.log_lik() == pytest.approx(js.log_lik(), rel=1e-10)
    assert ps.AIC_marginal() == pytest.approx(js.AIC_marginal(), rel=1e-10)


def test_edf_conditional_aic_and_bic_match_jax(pair):
    ps, js, _, _, _ = pair
    edf = ps.edf_conditional()
    assert edf == pytest.approx(js.edf_conditional(), rel=1e-8)
    assert ps.AIC_conditional() == pytest.approx(js.AIC_conditional(),
                                                 rel=1e-8)
    assert ps.BIC() == pytest.approx(js.BIC(), rel=1e-8)
    assert ps.AIC_conditional() == pytest.approx(
        -2 * ps.log_lik() + 2 * edf, rel=1e-12)


def test_simulate_and_check_post_match_jax(pair):
    ps, js, _, _, _ = pair
    for posterior in (False, True):
        got = ps.simulate(posterior=posterior, rng=np.random.default_rng(11))
        want = js.simulate(posterior=posterior,
                           rng=np.random.default_rng(11))
        for r in ps.response():
            np.testing.assert_allclose(got[r], want[r], **TIGHT)
    resp = ps.response()[0]

    def stat(d):
        z = np.asarray(d[resp], float)
        return [np.nanmean(np.diff(z)), np.nanstd(np.diff(z))]

    got = ps.check_post(stat, n_sims=5, silent=True,
                        rng=np.random.default_rng(12))
    want = js.check_post(stat, n_sims=5, silent=True,
                         rng=np.random.default_rng(12))
    np.testing.assert_allclose(got["obs_stat"], want["obs_stat"], **REL10)
    np.testing.assert_allclose(got["stats"], want["stats"], **REL10)


def test_printing_matches_jax(pair, capsys, monkeypatch):
    """eqn, stationary, message and print_par print the JAX package's
    text exactly (print_par's CI from the same default generator)."""
    ps, js, _, _, _ = pair
    assert ps.eqn() == js.eqn()
    outs = []
    seeded = np.random.default_rng
    for m in (ps, js):
        monkeypatch.setattr(np.random, "default_rng",
                            lambda seed=None: seeded(13))
        assert m.stationary() == js.stationary()
        m.message()
        m.print_par()
        m.print()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


def test_plot_par_draws_every_parameter(pair):
    pytest.importorskip("matplotlib")
    ps, _, _, _, var = pair
    fig = ps.plot_par(var, n_post=5, rng=np.random.default_rng(1))
    assert len(fig.axes) == len(ps.par_names())
    fig = ps.plot_par(var, show_CI="pointwise", n_post=100,
                      par_names=ps.par_names()[:1],
                      rng=np.random.default_rng(1))
    assert len(fig.axes) == 1


def test_post_coeff_raises_on_mismatched_blocks(pair):
    """Where the covariance does not cover a block's free entries (here a
    fit with inner coefficients but no joint precision), the port raises
    instead of keeping the point estimates as the JAX package does."""
    ps, _, kw, _, _ = pair
    r = ps.out()
    m = SDE(**kw, device="cpu", dtype=F64)
    m._fit_result = type(r)(**{**r.__dict__, "joint_precision": None,
                               "joint_names": None})
    if not len(r.bhat):  # cov_fixed covers every free entry
        assert m.post_coeff(5)["coeff_fe"].shape == (5, len(ps.coeff_fe()))
        return
    with pytest.raises(ValueError, match="coeff_re"):
        m.post_coeff(5, rng=np.random.default_rng(0))


def _refit_free(ps, kw):
    """A fresh port model holding ps's fit (no refit)."""
    m = SDE(**kw, device="cpu", dtype=F64)
    m._fit_result = ps.out()
    m.update_coeff_fe(ps.coeff_fe())
    m.update_coeff_re(ps.coeff_re())
    m.update_lambda(ps.lambda_())
    return m


def test_kalman_impl_choices(pair):
    """setup(kalman_impl=): "sequential" gives the kernel route's
    log-likelihood; an unknown value raises ValueError; setup(mesh="auto")
    (one CPU shard) and a mesh of three CPU shards give the fit's
    log-likelihood through the sharded route."""
    from smoothsde_tpu_torch.parallel.batching import make_mesh

    ps, _, kw, _, _ = pair
    m = _refit_free(ps, kw)
    m.setup(kalman_impl="sequential")
    assert m.log_lik() == pytest.approx(ps.log_lik(), rel=1e-10)
    with pytest.raises(ValueError):
        m.setup(kalman_impl="nope")
    for mesh in ("auto", make_mesh(3, device="cpu")):
        assert m.setup(mesh=mesh).uses_mesh
        assert m.log_lik() == pytest.approx(ps.log_lik(), rel=1e-10)


@pytest.mark.parametrize("impl", ["auto", "soa", "sequential", "parallel",
                                  "sqrt"])
def test_every_kalman_impl_gives_the_log_lik(pair, impl):
    """Every kalman_impl of the JAX package builds, and its value route
    (the fused kernels' plain versions, the per-dim sequential or
    parallel filter, the square-root filter) gives the fit's log_lik
    within 1e-10 relative; the closed-form models ignore it."""
    ps, _, kw, _, _ = pair
    m = _refit_free(ps, kw)
    m.setup(kalman_impl=impl)
    assert m.log_lik() == pytest.approx(ps.log_lik(), rel=1e-10)


def test_fit_verbose_prints_the_message(capsys):
    kw = _bm(n=60)
    SDE(**kw, device="cpu", dtype=F64).fit(verbose=True,
                                           compute_sdreport=False)
    out = capsys.readouterr().out
    assert "### smoothsde-tpu model ###" in out and "> SDE for BM" in out


def test_top_level_exports_match_jax():
    import smoothsde_tpu
    import smoothsde_tpu_torch

    assert set(smoothsde_tpu_torch.__all__) == set(smoothsde_tpu.__all__)
    assert smoothsde_tpu_torch.MODEL_TYPES == smoothsde_tpu.MODEL_TYPES
    spec = smoothsde_tpu_torch.get_model_spec("CTCRW", 2)
    assert spec.param_names == smoothsde_tpu.get_model_spec(
        "CTCRW", 2).param_names
    np.testing.assert_allclose(smoothsde_tpu_torch.ctcrw_cov(0.5, 1.2, 0.3),
                               smoothsde_tpu.ctcrw_cov(0.5, 1.2, 0.3),
                               **TIGHT)
    np.testing.assert_array_equal(
        smoothsde_tpu_torch.term_indices(["a.x", "b"], ["s(x).1"], "x")["re"],
        smoothsde_tpu.term_indices(["a.x", "b"], ["s(x).1"], "x")["re"])
    P = np.array([[2.0, 0.3], [0.3, 1.0]])
    np.testing.assert_allclose(smoothsde_tpu_torch.prec_to_cov(P),
                               smoothsde_tpu.prec_to_cov(P), **TIGHT)


def test_checkpoint_refuses_another_type(pair, tmp_path):
    ps, _, _, _, _ = pair
    path = os.path.join(tmp_path, "c.npz")
    ps.save_state(path)
    other = SDE(**_bm(n=40), device="cpu", dtype=F64) if ps.type() != "BM" \
        else SDE(**_ou_smooth(n=40), device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="checkpoint is for type"):
        other.load_state(path)
