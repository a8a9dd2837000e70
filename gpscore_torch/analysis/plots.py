"""Matplotlib figures of the analysis suite (port of `gpscore/analysis/plots.py`).

Covers:
- predictive interval plot over a 1-D test grid (mean +/- 2 sd band, train points)
  — `SIMPLE-FITC--comapre.py:546-622` / `SIMPLE-DATA FULL-comapre.py:482-501`;
- inducing-point migration plot (initial vs learned locations)
  — `SIMPLE-FITC--comapre.py:610-613`;
- objective-surface contour plot with the truth marked — `contour-plot.R:109-134`;
- CRPS area illustration — `crps-plot.R`;
- scoring-rule sensitivity curves — `relative-change-NEW.R`.

All functions take the data of :mod:`gpscore_torch.analysis.surfaces`,
``.sensitivity`` and ``.crps_illustration`` (tensors on any device, arrays or
lists) and only draw; matplotlib is imported lazily (:func:`pyplot`), so
library use without figures never needs it.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(v):
    """``v`` as a numpy array: a tensor through ``.detach().cpu().numpy()``."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def interval_plot(
    ax, test_x, mean, var, train_x=None, train_y=None, test_y=None, title=None
):
    """Mean +/- 2 sd predictive band over sorted 1-D inputs (the per-objective
    figure the synthetic scripts draw, `SIMPLE-DATA FULL-comapre.py:482-501`)."""
    x = np.ravel(_np(test_x))
    order = np.argsort(x)
    m = np.ravel(_np(mean))[order]
    sd = np.sqrt(np.ravel(_np(var))[order])
    xs = x[order]
    ax.fill_between(xs, m - 2 * sd, m + 2 * sd, alpha=0.3, label="95% interval")
    ax.plot(xs, m, lw=1.5, label="predictive mean")
    if test_y is not None:
        ax.plot(xs, np.ravel(_np(test_y))[order], ".", ms=2, label="test y")
    if train_x is not None:
        ax.plot(
            np.ravel(_np(train_x)),
            np.ravel(_np(train_y)),
            "k.",
            ms=3,
            label="train",
        )
    if title:
        ax.set_title(title)
    ax.legend(fontsize=7)


def inducing_migration_plot(ax, initial, learned, y_at=0.0):
    """Initial vs learned inducing locations (1-D), the reference's migration
    figure (`SIMPLE-FITC--comapre.py:610-613`)."""
    ini = np.ravel(_np(initial))
    fin = np.ravel(_np(learned))
    ax.plot(ini, np.full_like(ini, y_at + 0.1), "v", label="initial inducing")
    ax.plot(fin, np.full_like(fin, y_at - 0.1), "^", label="learned inducing")
    for a, b in zip(ini, fin):
        ax.annotate(
            "",
            xy=(b, y_at - 0.1),
            xytext=(a, y_at + 0.1),
            arrowprops=dict(arrowstyle="->", lw=0.5, alpha=0.5),
        )
    ax.legend(fontsize=7)


def contour_plot(ax, lengthscales, noise_sds, surface, truth=None, title=None):
    """Objective contour over (lengthscale, noise sd) with the truth cross-hair
    (`contour-plot.R:109-134` marks truth with red ablines at `:117,125`)."""
    L, S = _np(lengthscales), _np(noise_sds)
    Z = _np(surface)
    cs = ax.contour(S, L, Z, levels=20, linewidths=0.7)
    ax.clabel(cs, inline=True, fontsize=5)
    if truth is not None:
        true_l, true_s = truth
        ax.axhline(true_l, color="red", lw=0.8)
        ax.axvline(true_s, color="red", lw=0.8)
    ax.set_xlabel("noise sd")
    ax.set_ylabel("lengthscale")
    if title:
        ax.set_title(title)


def crps_area_plot(ax, curves, title="CRPS as area"):
    """The paper's CRPS illustration (`crps-plot.R:3-36`): forecast CDF vs
    observation Heaviside, with the integrand (F - H)^2 — whose area IS the
    CRPS — shaded."""
    t = _np(curves.t)
    ax.plot(t, _np(curves.forecast_cdf), label="forecast CDF F")
    ax.plot(t, _np(curves.obs_cdf), "k--", label="observation H(t - y)")
    ax.fill_between(
        t,
        _np(curves.integrand),
        0.0,
        alpha=0.3,
        label=(
            r"$(F-H)^2$: area = CRPS = " f"{float(curves.crps_numeric):.3f}"
        ),
    )
    ax.set_title(title)
    ax.legend(fontsize=7)


def sensitivity_plot(ax, sweep_values, curves: dict, xlabel, title=None):
    """Relative-change curves per scoring rule (`relative-change-NEW.R:80-214`)."""
    for name, c in curves.items():
        ax.plot(_np(sweep_values), _np(c), label=name, lw=1.2)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("relative change")
    if title:
        ax.set_title(title)
    ax.legend(fontsize=7)


def save_figure(fig, path: str, dpi: int = 150):
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
