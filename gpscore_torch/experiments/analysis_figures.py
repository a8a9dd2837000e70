"""The analysis and figure suite on one device (port of `experiments/analysis_figures.py`).

Covers the reference's three R scripts and the Python scripts' plotting tails:

- the objective surfaces (NLML, LOO-CRPS, LOO-logs, the "wrong" in-sample
  CRPS) over a (lengthscale, noise-sd) grid with the generating truth marked
  (`contour-plot.R:88-144`), each one batched evaluation: one Gram kernel
  launch for the whole grid, then batched solves;
- the CRPS-as-area illustration (`crps-plot.R:3-36`), sigma = 1 and 0.05;
- the twelve scoring-rule sensitivity curves at the R script's grids
  (`relative-change-NEW.R:6-17, 80-214`);
- the predictive interval and inducing-migration figures of a 200-iteration
  FITC crps fit (`SIMPLE-FITC--comapre.py:546-622`).

The figure data is always written (``save_pytree`` / ``save_metrics``):
``surfaces.npz``, ``crps_illustration.npz``, ``sensitivity.npz``,
``fitc_fit.npz`` (the FitResult with its parameter history, the initial
inducing points and the predictive) and ``analysis_figures.json`` (sizes,
timings, summaries). The four PNGs are drawn too unless ``--no-png``;
without matplotlib that raises. The synthetic data comes from seeded CPU
generators (42 for the surfaces, 1 for the fit), so every device sees the
same data; the curves draw from a generator on the device, seeded 0. None
of these draws is JAX's.

    python -m gpscore_torch.experiments.analysis_figures [--outdir figures_torch] [--grid 50]
        [--n-contour 20] [--device cuda] [--no-png]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from gpscore_torch.analysis import (
    crps_illustration,
    crps_mean_error_curve,
    crps_var_error_curve,
    dss_correlation_family,
    dss_mean_error_curve,
    dss_var_error_curve,
    es_correlation_family,
    es_mean_error_curve,
    es_var_error_curve,
    logs_mean_error_curve,
    logs_var_error_curve,
    objective_surface,
    plots,
)
from gpscore_torch.data import sample_synthetic_1d
from gpscore_torch.experiments.common import resolve_device, synchronize
from gpscore_torch.fit import fit_gd, make_objective
from gpscore_torch.models.fitc import fitc_predictive
from gpscore_torch.utils.checkpoint import save_metrics, save_pytree
from gpscore_torch.utils.params import init_unit_params

SURFACES = [("nlml", "NLML"), ("crps", "LOO-CRPS"), ("logs", "LOO-logs"),
            ("wrong_crps", '"wrong" (in-sample) CRPS')]
TRUTH = (1.0, 0.3)  # the generating lengthscale and noise sd


def synthetic(seed: int, device, **sizes):
    """sample_synthetic_1d from a CPU generator seeded ``seed``, on ``device``."""
    d = sample_synthetic_1d(torch.Generator().manual_seed(seed), **sizes)
    return type(d)(*(t.to(device) for t in d))


def sensitivity_grids(device):
    """The R script's sweep grids (`relative-change-NEW.R:6-17`): pre_mu -5..5
    by 0.5, pre_sigma_sq 0.05..0.95 by 0.1 then 1..10 by 1, true_corr
    0.2..0.8 by 0.2, range_corr 0..0.9 by 0.1."""
    f32 = dict(dtype=torch.float32, device=device)
    pre_var = torch.cat([0.05 + 0.1 * torch.arange(10, **f32), torch.arange(1, 11, **f32)])
    return (torch.linspace(-5.0, 5.0, 21, **f32), pre_var, [0.2, 0.4, 0.6, 0.8],
            0.1 * torch.arange(10, **f32))


def sensitivity_curves(generator, pre_mu, pre_var, true_rhos, range_corr):
    """The twelve curves at the R grids and the JAX driver's sizes: 10,000
    targets, 500 data and 100 draws; the ES families 200 data and 64 draws."""
    return {
        "crps_mean": crps_mean_error_curve(generator, pre_mu),
        "logs_mean": logs_mean_error_curve(generator, pre_mu),
        "dss_mean": dss_mean_error_curve(generator, pre_mu),
        "es_mean": es_mean_error_curve(generator, pre_mu),
        "crps_var": crps_var_error_curve(generator, pre_var),
        "logs_var": logs_var_error_curve(generator, pre_var),
        "dss_var": dss_var_error_curve(generator, pre_var),
        "es_var": es_var_error_curve(generator, pre_var),
        "dss_corr_family": dss_correlation_family(generator, true_rhos, range_corr),
        "es_corr_family": es_correlation_family(generator, true_rhos, range_corr, num_sim=64),
    }


def argmin_point(z, ls, ns):
    """(lengthscale, noise sd) of a surface's least finite value."""
    i = int(torch.nan_to_num(z, nan=float("inf")).argmin())
    return [float(ls[i // z.shape[1]]), float(ns[i % z.shape[1]])]


def _draw(plt, outdir, name, shape, figsize, draw, **kw):
    fig, axes = plt.subplots(*shape, figsize=figsize, **kw)
    draw(axes)
    plots.save_figure(fig, os.path.join(outdir, name))
    plt.close(fig)


def _sensitivity_axes(axes, grids, c):
    pre_mu, pre_var, true_rhos, range_corr = grids
    norm_mean_err = -pre_mu  # (true_mu - pre_mu) / true_sigma_sq
    norm_var_err = 1.0 - pre_var  # (true_sigma_sq - pre_sigma_sq) / true_sigma_sq
    sp = plots.sensitivity_plot
    sp(axes[0, 0], norm_mean_err, {"CRPS": c["crps_mean"], "log score": c["logs_mean"]},
       xlabel="normalized mean error", title="CRPS / log score: mean error")
    sp(axes[0, 1], norm_mean_err, {"DSS": c["dss_mean"]},
       xlabel="normalized mean error", title="DSS: mean error")
    sp(axes[0, 2], norm_mean_err, {"ES": c["es_mean"]},
       xlabel="normalized mean error", title="ES: mean error")
    sp(axes[1, 0], norm_var_err, {"CRPS": c["crps_var"], "log score": c["logs_var"]},
       xlabel="normalized variance error", title="CRPS / log score: variance error")
    sp(axes[1, 1], norm_var_err, {"DSS": c["dss_var"]},
       xlabel="normalized variance error", title="DSS: variance error")
    # R plots ES only for pre_sigma_sq >= 0.55 (`relative-change-NEW.R:186-187`),
    # where the Monte-Carlo estimate is stable.
    sp(axes[1, 2], norm_var_err[5:], {"ES": c["es_var"][5:]},
       xlabel="normalized variance error", title="ES: variance error")
    for ax, fam, title in ((axes[2, 0], "dss_corr_family", "DSS: correlation error"),
                           (axes[2, 1], "es_corr_family", "ES: correlation error")):
        sp(ax, range_corr, {f"rho = {r}": c[fam][i] for i, r in enumerate(true_rhos)},
           xlabel="predictive correlation", title=title)
    axes[2, 2].axis("off")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="figures_torch",
                    help="where the data and PNGs go (figures/ holds the JAX driver's)")
    ap.add_argument("--grid", type=int, default=50, help="contour grid resolution")
    ap.add_argument("--n-contour", type=int, default=20,
                    help="synthetic points for the surfaces (contour-plot.R uses 20)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--no-png", action="store_true",
                    help="write the figure data only, draw no PNG (needs no matplotlib)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    plt = None if args.no_png else plots.pyplot()  # raises here without matplotlib
    os.makedirs(args.outdir, exist_ok=True)
    timings, files = {}, []

    def timed(name, fn):
        synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        timings[name] = time.perf_counter() - t0
        return out

    def write(name, tree):
        save_pytree(os.path.join(args.outdir, name), tree)
        files.append(name)

    # --- objective surfaces (contour-plot.R) ---
    d20 = synthetic(42, device, num_train=args.n_contour, num_test=8, num_va=8)
    f32 = dict(dtype=torch.float32, device=device)
    ls = torch.linspace(0.2, 4.0, args.grid, **f32)
    ns = torch.linspace(0.05, 1.5, args.grid, **f32)
    surfaces = {rule: timed(f"surface_{rule}", lambda r=rule: objective_surface(
        d20.train_x, d20.train_y, ls, ns, rule=r)) for rule, _ in SURFACES}
    write("surfaces.npz", {"lengthscales": ls, "noise_sds": ns, **surfaces})

    # --- CRPS area illustration (crps-plot.R) ---
    crps_curves = timed("crps_illustration", lambda: {
        "sigma_1": crps_illustration(sigma=1.0, device=device),
        "sigma_0.05": crps_illustration(sigma=0.05, device=device)})
    write("crps_illustration.npz", crps_curves)

    # --- sensitivity curves (relative-change-NEW.R, all twelve) ---
    grids = sensitivity_grids(device)
    generator = torch.Generator(device).manual_seed(0)
    curves = timed("sensitivity", lambda: sensitivity_curves(generator, *grids))
    write("sensitivity.npz", {"pre_mu": grids[0], "pre_sigma_sq": grids[1],
                              "range_corr": grids[3], **curves})

    # --- a quick FITC fit: the interval and inducing-migration figures ---
    d = synthetic(1, device)
    u0 = torch.linspace(-3.0, 3.0, 5, **f32).reshape(5, 1)
    p0 = init_unit_params(d=1, isotropic=False, inducing=u0, device=device)
    loss = make_objective("crps", model="fitc")
    res = timed("fitc_fit", lambda: fit_gd(loss, p0, d.train_x, d.train_y, iters=200, lr=1.0,
                                           record_params=True))
    pred = fitc_predictive(d.train_x, d.train_y, d.test_x, res.params)
    pred_var = torch.diagonal(pred.cov)
    write("fitc_fit.npz", {"result": res, "initial_inducing": u0, "pred_mean": pred.mean,
                           "pred_var": pred_var})

    summary = {
        "device": str(device), "grid": args.grid, "n_contour": args.n_contour,
        "timings_s": timings,
        "surface_argmin": {r: argmin_point(z, ls, ns) for r, z in surfaces.items()},
        "surface_nonfinite": {r: int((~torch.isfinite(z)).sum()) for r, z in surfaces.items()},
        "crps_numeric": {k: c.crps_numeric for k, c in crps_curves.items()},
        "fitc_final_loss": res.loss_history[-1], "fitc_ok": res.ok,
    }
    save_metrics(os.path.join(args.outdir, "analysis_figures.json"), summary)
    files.append("analysis_figures.json")

    if plt is not None:
        def surface_axes(axes):
            for ax, (rule, title) in zip(axes.ravel(), SURFACES):
                plots.contour_plot(ax, ls, ns, surfaces[rule], truth=TRUTH, title=title)

        def crps_axes(axes):
            plots.crps_area_plot(axes[0], crps_curves["sigma_1"], title="probabilistic forecast")
            plots.crps_area_plot(axes[1], crps_curves["sigma_0.05"],
                                 title="(near-)deterministic forecast")

        def fit_axes(axes):
            plots.interval_plot(axes[0], d.test_x, pred.mean, pred_var, d.train_x, d.train_y,
                                d.test_y, title="FITC CRPS-LOO predictive")
            plots.inducing_migration_plot(axes[1], u0, res.params.inducing)

        _draw(plt, args.outdir, "objective_surfaces.png", (2, 2), (10, 8), surface_axes)
        _draw(plt, args.outdir, "crps_illustration.png", (1, 2), (10, 4), crps_axes)
        _draw(plt, args.outdir, "sensitivity_curves.png", (3, 3), (15, 11),
              lambda axes: _sensitivity_axes(axes, grids, curves), constrained_layout=True)
        _draw(plt, args.outdir, "fitc_fit.png", (1, 2), (12, 4), fit_axes)
        files += ["objective_surfaces.png", "crps_illustration.png", "sensitivity_curves.png",
                  "fitc_fit.png"]
    for name in files:
        print(f"wrote {name}")
    return {"surfaces": surfaces, "crps_illustration": crps_curves, "curves": curves,
            "fit": res, "prediction": pred, "timings": timings, "files": files}


if __name__ == "__main__":
    main()
