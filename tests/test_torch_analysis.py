"""The port's analysis suite (gpscore_torch.analysis and its two drivers)
against gpscore.analysis, on the CPU at small sizes.

Inputs come from numpy seeds; the sensitivity curves get JAX's own draws,
rebuilt here from the same keys in the layout each JAX function draws them,
and passed across as ``eps``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore import analysis as janalysis
from gpscore.scoring.rules import crps_gaussian as jax_crps
from gpscore_torch import analysis as tanalysis
from gpscore_torch.analysis import plots, sensitivity as tsens, surfaces as tsurf
from gpscore_torch.experiments import analysis_figures, parity_report
from gpscore_torch.utils.checkpoint import load_metrics, load_pytree
from torch_parity import t

RULES = ["nlml", "crps", "logs", "wrong_crps"]


def _surface_data(seed=3, n=12):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((n, 1))).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.3 * rng.standard_normal(n)).astype(np.float32)
    ls = np.linspace(0.2, 4.0, 6).astype(np.float32)
    ns = np.linspace(0.05, 1.5, 5).astype(np.float32)
    return x, y, ls, ns


def test_analysis_exports_the_jax_packages_names():
    assert tanalysis.__all__ == janalysis.__all__
    assert all(hasattr(tanalysis, name) for name in tanalysis.__all__)


# ---- objective surfaces ---------------------------------------------------------


@pytest.mark.parametrize("logs_noise_in_var", [True, False])
@pytest.mark.parametrize("rule", RULES)
def test_objective_surface_matches_jax(rule, logs_noise_in_var):
    """The 6 x 5 grid as one batch of 30 exact GPs against the JAX vmap:
    the same finite points, values within rtol 3e-4 (fp32 solves at noise
    sd 0.05, where K_hat's condition number reaches ~1e4; the largest gap
    read 6e-5)."""
    x, y, ls, ns = _surface_data()
    want = np.asarray(janalysis.objective_surface(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(ls), jnp.asarray(ns), rule=rule,
        logs_noise_in_var=logs_noise_in_var))
    got = tanalysis.objective_surface(t(x), t(y), t(ls), t(ns), rule=rule,
                                      logs_noise_in_var=logs_noise_in_var).numpy()
    assert got.shape == (6, 5)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=3e-4)


def test_objective_surface_takes_the_grid_as_one_batched_gram(monkeypatch):
    """One Gram of B = Gl Gs for the whole grid: log_signal_sq zeros [B],
    the lengths [B], and y left [n] (shared by every grid point)."""
    x, y, ls, ns = _surface_data()
    seen = []
    real_gram = tsurf.gram

    def spy(a, b, log_signal_sq, log_length, *, kind):
        seen.append((tuple(log_signal_sq.shape), tuple(log_length.shape), kind))
        return real_gram(a, b, log_signal_sq, log_length, kind=kind)

    monkeypatch.setattr(tsurf, "gram", spy)
    tanalysis.objective_surface(t(x), t(y), t(ls), t(ns), rule="crps")
    assert seen == [((30,), (30,), "rbf")]


def test_a_failed_grid_point_is_nan_alone():
    """Noise sd 0 at a long lengthscale makes K_hat the all-ones matrix,
    whose factor fails: that point alone is NaN, and the rest of its row
    and column equal the same grid without it."""
    x, y, _, _ = _surface_data()
    ls = t(np.array([0.5, 1.0, 1e4], np.float32))
    ns = t(np.array([0.0, 0.3, 0.9], np.float32))
    z = tanalysis.objective_surface(t(x), t(y), ls, ns, rule="nlml")
    assert torch.isnan(z[2, 0])
    assert torch.isfinite(z[:, 1:]).all()
    rest = tanalysis.objective_surface(t(x), t(y), ls, ns[1:], rule="nlml")
    torch.testing.assert_close(z[:, 1:], rest, rtol=1e-6, atol=0.0)


def test_objective_surface_refuses_an_unknown_rule():
    x, y, ls, ns = _surface_data()
    with pytest.raises(ValueError, match="unknown rule"):
        tanalysis.objective_surface(t(x), t(y), t(ls), t(ns), rule="dss")


@pytest.mark.parametrize("lengthscale,noise_sd", [(1.0, 0.3), (0.4, 0.05), (3.0, 1.2)])
def test_wrong_crps_objective_matches_jax(lengthscale, noise_sd):
    x, y, _, _ = _surface_data(seed=5)
    want = float(janalysis.wrong_crps_objective(jnp.asarray(x), jnp.asarray(y),
                                                jnp.float32(lengthscale),
                                                jnp.float32(noise_sd)))
    got = tanalysis.wrong_crps_objective(t(x), t(y), lengthscale, noise_sd)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=3e-4)
    # The batched form gives each pair's own score (batched solves round in
    # another order: 2.6e-6 apart at noise sd 0.05).
    batched = tanalysis.wrong_crps_objective(t(x), t(y), t(np.float32([lengthscale, 2.0])),
                                             t(np.float32([noise_sd, 0.5])))
    np.testing.assert_allclose(float(batched[0]), float(got), rtol=2e-5)


def test_wrong_crps_surface_is_degenerate_in_noise():
    """The in-sample CRPS falls toward zero noise (`contour-plot.R:55-64`),
    where the LOO-CRPS has an interior minimum near the truth."""
    x, y, _, _ = _surface_data(seed=7, n=20)
    ns = torch.linspace(0.02, 1.0, 12)
    z = tanalysis.objective_surface(t(x), t(y), torch.tensor([1.0]), ns, rule="wrong_crps")[0]
    assert float(ns[int(z.argmin())]) < 0.15
    ls = torch.linspace(0.2, 4.0, 16)
    ns = torch.linspace(0.05, 1.5, 16)
    z = tanalysis.objective_surface(t(x), t(y), ls, ns, rule="crps")
    i, j = divmod(int(z.argmin()), 16)
    assert 0 < i < 15 and 0 < j < 15 and float(ns[j]) < 0.8


# ---- sensitivity curves ---------------------------------------------------------


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _es_eps(key, num_data, num_sim, dim=2):
    """The normals JAX's es curves draw: k_data, k_es = split(key); the data
    from k_data; per datum split(split(k_es, N)[i]) -> k1, k2, (S, dim) each."""
    k_data, k_es = jax.random.split(key)

    def per_datum(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.normal(k1, (num_sim, dim), jnp.float32),
                jax.random.normal(k2, (num_sim, dim), jnp.float32))

    e1, e2 = jax.vmap(per_datum)(jax.random.split(k_es, num_data))
    return t(_normal(k_data, (num_data, dim))), t(np.asarray(e1)), t(np.asarray(e2))


def _stack(parts):
    if isinstance(parts[0], tuple):
        return tuple(torch.stack(p) for p in zip(*parts))
    return torch.stack(parts)


PRE_MU = np.linspace(-3.0, 3.0, 9).astype(np.float32)
PRE_VAR = np.array([0.25, 0.55, 1.0, 2.0, 5.0], np.float32)
RHOS = np.arange(0.0, 0.95, 0.1).astype(np.float32)
TRUE_RHOS = [0.2, 0.6]
N_MC, N_DATA, N_SIM = 500, 60, 24

# name: (JAX call at key, port call at eps, the normals from key)
CURVES = {
    "crps_mean_error_curve": (
        lambda k: janalysis.crps_mean_error_curve(k, jnp.asarray(PRE_MU), n=N_MC),
        lambda e: tanalysis.crps_mean_error_curve(None, t(PRE_MU), n=N_MC, eps=e),
        lambda k: t(_normal(k, (N_MC,)))),
    "crps_var_error_curve": (
        lambda k: janalysis.crps_var_error_curve(k, jnp.asarray(PRE_VAR), n=N_MC),
        lambda e: tanalysis.crps_var_error_curve(None, t(PRE_VAR), n=N_MC, eps=e),
        lambda k: t(_normal(k, (N_MC,)))),
    "logs_mean_error_curve": (
        lambda k: janalysis.logs_mean_error_curve(k, jnp.asarray(PRE_MU), n=N_MC),
        lambda e: tanalysis.logs_mean_error_curve(None, t(PRE_MU), n=N_MC, eps=e),
        lambda k: t(_normal(k, (N_MC,)))),
    "logs_var_error_curve": (
        lambda k: janalysis.logs_var_error_curve(k, jnp.asarray(PRE_VAR), n=N_MC),
        lambda e: tanalysis.logs_var_error_curve(None, t(PRE_VAR), n=N_MC, eps=e),
        lambda k: t(_normal(k, (N_MC,)))),
    "dss_mean_error_curve": (
        lambda k: janalysis.dss_mean_error_curve(k, jnp.asarray(PRE_MU), num_data=N_DATA),
        lambda e: tanalysis.dss_mean_error_curve(None, t(PRE_MU), num_data=N_DATA, eps=e),
        lambda k: t(_normal(k, (N_DATA, 2)))),
    "dss_var_error_curve": (
        lambda k: janalysis.dss_var_error_curve(k, jnp.asarray(PRE_VAR), num_data=N_DATA),
        lambda e: tanalysis.dss_var_error_curve(None, t(PRE_VAR), num_data=N_DATA, eps=e),
        lambda k: t(_normal(k, (N_DATA, 2)))),
    "es_mean_error_curve": (
        lambda k: janalysis.es_mean_error_curve(k, jnp.asarray(PRE_MU), num_data=N_DATA,
                                                num_sim=N_SIM),
        lambda e: tanalysis.es_mean_error_curve(None, t(PRE_MU), num_data=N_DATA,
                                                num_sim=N_SIM, eps=e),
        lambda k: _es_eps(k, N_DATA, N_SIM)),
    "es_var_error_curve": (
        lambda k: janalysis.es_var_error_curve(k, jnp.asarray(PRE_VAR), num_data=N_DATA,
                                               num_sim=N_SIM),
        lambda e: tanalysis.es_var_error_curve(None, t(PRE_VAR), num_data=N_DATA,
                                               num_sim=N_SIM, eps=e),
        lambda k: _es_eps(k, N_DATA, N_SIM)),
    "dss_correlation_curve": (
        lambda k: janalysis.dss_correlation_curve(k, 0.5, jnp.asarray(RHOS), num_data=N_DATA),
        lambda e: tanalysis.dss_correlation_curve(None, 0.5, t(RHOS), num_data=N_DATA, eps=e),
        lambda k: t(_normal(k, (N_DATA, 2)))),
    "es_correlation_curve": (
        lambda k: janalysis.es_correlation_curve(k, 0.4, jnp.asarray(RHOS), num_data=N_DATA,
                                                 num_sim=N_SIM),
        lambda e: tanalysis.es_correlation_curve(None, 0.4, t(RHOS), num_data=N_DATA,
                                                 num_sim=N_SIM, eps=e),
        lambda k: _es_eps(k, N_DATA, N_SIM)),
    "dss_correlation_family": (
        lambda k: janalysis.dss_correlation_family(k, TRUE_RHOS, jnp.asarray(RHOS),
                                                   num_data=N_DATA),
        lambda e: tanalysis.dss_correlation_family(None, TRUE_RHOS, t(RHOS), num_data=N_DATA,
                                                   eps=e),
        lambda k: _stack([t(_normal(jax.random.fold_in(k, i), (N_DATA, 2)))
                          for i in range(len(TRUE_RHOS))])),
    "es_correlation_family": (
        lambda k: janalysis.es_correlation_family(k, TRUE_RHOS, jnp.asarray(RHOS),
                                                  num_data=N_DATA, num_sim=N_SIM),
        lambda e: tanalysis.es_correlation_family(None, TRUE_RHOS, t(RHOS), num_data=N_DATA,
                                                  num_sim=N_SIM, eps=e),
        lambda k: _stack([_es_eps(jax.random.fold_in(k, i), N_DATA, N_SIM)
                          for i in range(len(TRUE_RHOS))])),
}


@pytest.mark.parametrize("name", sorted(CURVES))
def test_sensitivity_curve_matches_jax_at_its_draws(name):
    """Each of the twelve curves at JAX's own normals: within 2e-5 of the
    curve's largest magnitude (a curve is a relative change, ~0 at the truth,
    so its own rtol would be meaningless there; the gaps read <= 3e-6)."""
    jax_call, port_call, draws = CURVES[name]
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_call(key))
    got = port_call(draws(key)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_curves_draw_from_a_generator_with_common_numbers_across_the_sweep():
    """With a generator the draws are the port's own: a curve is finite,
    repeats at the same seed, and each es datum's draws are shared by every
    mu (the same data at mu = 0 give the truth, so the curve is 0 there)."""
    def curve(seed):
        return tanalysis.es_mean_error_curve(torch.Generator().manual_seed(seed),
                                             t(PRE_MU), num_data=N_DATA, num_sim=N_SIM)

    a, b = curve(3), curve(3)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert float(a[int(np.argmin(np.abs(PRE_MU)))]) == 0.0
    with pytest.raises(ValueError, match="generator"):
        tanalysis.crps_mean_error_curve(None, t(PRE_MU))


def test_es_correlation_curve_jitters_each_rho_and_datum_alone(monkeypatch):
    """The [rho, datum] batch of rules.energy_score takes its jitter rung
    per element (batch_dims=2)."""
    seen = []
    real = tsens.energy_score

    def spy(*a, **kw):
        seen.append((tuple(a[1].shape), kw["batch_dims"]))
        return real(*a, **kw)

    monkeypatch.setattr(tsens, "energy_score", spy)
    tanalysis.es_correlation_curve(torch.Generator().manual_seed(0), 0.4, t(RHOS),
                                   num_data=N_DATA, num_sim=N_SIM)
    assert seen == [((len(RHOS) + 1, N_DATA, 2, 2), 2)]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sensitivity_minima_at_the_truth():
    """The properties tests/test_analysis.py asserts of the JAX curves, at
    the port's own draws: each curve is least (or ~0) at the truth."""
    mus = torch.linspace(-2.0, 2.0, 21)
    c = tanalysis.crps_mean_error_curve(_gen(0), mus, n=4000)
    assert abs(float(mus[int(c.argmin())])) < 0.3
    rhos = torch.linspace(-0.6, 0.9, 16)
    c = tanalysis.dss_correlation_curve(_gen(1), 0.5, rhos, num_data=400)
    assert 0.2 < float(rhos[int(c.abs().argmin())]) < 0.8
    mus = torch.linspace(-3.0, 3.0, 13)
    c = tanalysis.dss_mean_error_curve(_gen(3), mus, num_data=400)
    assert abs(float(mus[int(c.argmin())])) < 0.6 and abs(float(c[6])) < 0.1
    ks = torch.cat([torch.linspace(0.25, 1.0, 6), torch.linspace(1.5, 6.0, 6)])
    c = tanalysis.dss_var_error_curve(_gen(4), ks, num_data=600)
    assert 0.5 < float(ks[int(c.argmin())]) < 2.0
    mus = torch.linspace(-3.0, 3.0, 7)
    c = tanalysis.es_mean_error_curve(_gen(5), mus, num_data=100, num_sim=64)
    assert abs(float(mus[int(c.argmin())])) < 1.1
    ks = torch.tensor([0.25, 0.5, 1.0, 2.0, 4.0, 8.0])
    c = tanalysis.es_var_error_curve(_gen(6), ks, num_data=150, num_sim=64)
    assert 0.4 < float(ks[int(c.argmin())]) < 2.5


def test_correlation_families_are_zero_at_each_truth():
    rr = 0.1 * torch.arange(10)
    dfam = tanalysis.dss_correlation_family(_gen(7), TRUE_RHOS, rr, num_data=400)
    efam = tanalysis.es_correlation_family(_gen(8), TRUE_RHOS, rr, num_data=60, num_sim=32)
    assert dfam.shape == efam.shape == (2, 10)
    assert torch.isfinite(dfam).all() and torch.isfinite(efam).all()
    # Each family is the score at rho less the score at the truth: 0 there.
    for i, tr in enumerate(TRUE_RHOS):
        j = int(np.argmin(np.abs(rr.numpy() - tr)))
        assert abs(float(dfam[i, j])) <= 1e-6 and abs(float(efam[i, j])) <= 1e-6


# ---- CRPS illustration and plots ------------------------------------------------


@pytest.mark.parametrize("sigma", [1.0, 0.05])
def test_crps_illustration_matches_jax_and_the_closed_form(sigma):
    want = janalysis.crps_illustration(sigma=sigma)
    got = tanalysis.crps_illustration(sigma=sigma, device="cpu")
    assert type(got).__name__ == "CRPSCurves" and got._fields == want._fields
    # The two linspaces differ by up to 2.4e-7 in t, which the CDF's slope
    # (~8 at sigma = 0.05) turns into ~2e-6; and they may round a grid point
    # onto either side of a step: the step curves agree off those points.
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.forecast_cdf.numpy(), np.asarray(want.forecast_cdf),
                               rtol=0, atol=1e-5)
    for name, step in (("deterministic_cdf", 0.0), ("obs_cdf", 1.0), ("integrand", 1.0)):
        off = np.abs(np.asarray(want.t) - step) > 1e-6
        np.testing.assert_allclose(getattr(got, name).numpy()[off],
                                   np.asarray(getattr(want, name))[off], rtol=0, atol=1e-5)
    # ... so their areas may differ by one trapezoid at the step, at most
    # the spacing (0.01) times (F - H)^2 <= 1.
    np.testing.assert_allclose(float(got.crps_numeric), float(want.crps_numeric), rtol=0,
                               atol=8.0 / 800)
    wide = tanalysis.crps_illustration(sigma=sigma, t_lo=-8.0, t_hi=8.0, num=4001,
                                       device="cpu")
    closed = float(jax_crps(jnp.float32(0.0), jnp.float32(sigma**2), jnp.float32(1.0)))
    np.testing.assert_allclose(float(wide.crps_numeric), closed, rtol=5e-3)
    F = wide.forecast_cdf.numpy()
    assert (np.diff(F) >= -3e-7).all() and 0.0 <= F.min() and F.max() <= 1.0


def test_plots_render_tensors_under_agg(tmp_path):
    plt = plots.pyplot()
    x, y, ls, ns = _surface_data()
    fig, axes = plt.subplots(2, 3, figsize=(9, 6))
    plots.interval_plot(axes[0, 0], t(x), torch.zeros(12), torch.ones(12), t(x), t(y), t(y),
                        title="interval")
    plots.inducing_migration_plot(axes[0, 1], torch.tensor([-1.0, 0.0]), torch.tensor([1.0, 2.0]))
    z = tanalysis.objective_surface(t(x), t(y), t(ls), t(ns), rule="nlml")
    plots.contour_plot(axes[0, 2], t(ls), t(ns), z, truth=(1.0, 0.3), title="nlml")
    plots.crps_area_plot(axes[1, 0], tanalysis.crps_illustration(device="cpu"))
    plots.sensitivity_plot(axes[1, 1], t(PRE_MU), {"CRPS": tanalysis.crps_mean_error_curve(
        _gen(0), t(PRE_MU), n=200)}, xlabel="mean error", title="curve")
    out = str(tmp_path / "fig.png")
    plots.save_figure(fig, out)
    plt.close(fig)
    assert os.path.getsize(out) > 1000


# ---- the drivers ----------------------------------------------------------------


def test_analysis_figures_runs_on_the_cpu_and_writes_its_data(tmp_path):
    out = analysis_figures.main(["--device", "cpu", "--outdir", str(tmp_path), "--grid", "6",
                                 "--n-contour", "10"])
    names = ["surfaces.npz", "crps_illustration.npz", "sensitivity.npz", "fitc_fit.npz",
             "analysis_figures.json", "objective_surfaces.png", "crps_illustration.png",
             "sensitivity_curves.png", "fitc_fit.png"]
    assert out["files"] == names
    assert all((tmp_path / f).stat().st_size > 0 for f in names)
    for rule, z in out["surfaces"].items():
        assert z.shape == (6, 6) and torch.isfinite(z).all(), rule
    assert len(out["curves"]) == 10 and all(torch.isfinite(c).all()
                                            for c in out["curves"].values())
    assert out["curves"]["es_corr_family"].shape == (4, 10)
    summary = load_metrics(str(tmp_path / "analysis_figures.json"))
    assert summary["fitc_ok"] and summary["grid"] == 6
    # The written data loads back through the structure it was written from.
    back = load_pytree(str(tmp_path / "fitc_fit.npz"),
                       {"result": out["fit"], "initial_inducing": 0, "pred_mean": 0,
                        "pred_var": 0})
    assert torch.equal(back["result"].param_history.inducing, out["fit"].param_history.inducing)
    assert back["result"].param_history.log_length.shape == (200, 1)


def test_analysis_figures_data_only_needs_no_matplotlib(tmp_path, monkeypatch):
    """--no-png writes the data alone; without it a missing matplotlib raises."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    argv = ["--device", "cpu", "--outdir", str(tmp_path), "--grid", "4", "--n-contour", "8"]
    out = analysis_figures.main(argv + ["--no-png"])
    assert not any(f.endswith(".png") for f in out["files"]) and len(out["files"]) == 5
    with pytest.raises(ImportError):
        analysis_figures.main(argv)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_parity_report_passes_every_target_on_the_cpu(tmp_path, dtype):
    path = str(tmp_path / "parity.json")
    assert parity_report.main(["--device", "cpu", "--dtype", dtype, "--n", "48",
                               "--out", path]) == 0
    report = json.load(open(path))
    assert sorted(report) == sorted(["gram", "posterior_mean", "posterior_cov", "loo_mean",
                                     "loo_var", "crps", "logs", "dss", "nlml"])
    assert all(r["pass"] for r in report.values())
    if dtype == "float64":
        assert all(r["target"] == 5e-9 for r in report.values())


def test_drivers_default_to_cuda_and_refuse_float64_there(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        parity_report.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        analysis_figures.main(["--no-png"])
    # The name is historical: the Gram kernels now have float64 builds, so
    # --dtype float64 on the default cuda device passes the script's own
    # argument checks and stops only where this CPU-only torch makes its first CUDA tensor.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(AssertionError, match="not compiled with CUDA"):
        parity_report.main(["--dtype", "float64"])
