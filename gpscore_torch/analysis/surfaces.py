"""Objective surfaces over hyperparameter grids (port of `gpscore/analysis/surfaces.py`).

The R script evaluates NLML, LOO-CRPS, LOO-logs and the "wrong" (in-sample)
CRPS on a (lengthscale, noise-sd) grid with nested loops
(`contour-plot.R:88-134`); the JAX package vmaps over both axes. Here the
Gl x Gs grid is one batch of B = Gl Gs exact GPs: one batched Gram kernel
launch builds every K [B, n, n] (:func:`gpscore_torch.ops.kernels.gram`,
chunked past 65,535 Grams), then the batched solves of
:mod:`gpscore_torch.models.exact` run on [B, n, n], the targets y [n] shared
by every grid point. A grid point whose factor fails is NaN alone.

Conventions follow the R script: the isotropic kernel takes the lengthscale
l (squared inside), the grid's second coordinate is the noise standard
deviation (variance sd^2, `contour-plot.R:45`), and ``logs_noise_in_var``
adds the noise variance to the LOO predictive variance for logs
(`contour-plot.R:81`).
"""

from __future__ import annotations

import torch

from gpscore_torch.models.exact import exact_predictive, loo_exact, nlml_exact
from gpscore_torch.ops.kernels import gram
from gpscore_torch.scoring.rules import crps_gaussian, logs_gaussian

RULES = ("nlml", "crps", "logs", "wrong_crps")


def _k_ff(x, lengthscale):
    """K(x, x) at unit signal for one lengthscale [] or a batch [B]."""
    return gram(x, x, torch.zeros_like(lengthscale), 2.0 * torch.log(lengthscale), kind="rbf")


def _as_grid(v, x):
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def wrong_crps_objective(x, y, lengthscale, noise_sd):
    """The negative control: CRPS of the in-sample posterior (not LOO), the
    degenerate objective of `contour-plot.R:55-64`, whose surface has no
    interior minimum in noise. ``lengthscale`` and ``noise_sd`` are one value
    each, or [B] each (one score per pair, [B])."""
    lengthscale, noise_sd = _as_grid(lengthscale, x), _as_grid(noise_sd, x)
    k_ff = _k_ff(x, lengthscale)
    pred = exact_predictive(k_ff, k_ff, k_ff, y, noise_sd**2)
    return crps_gaussian(pred.mean, torch.diagonal(pred.cov, dim1=-2, dim2=-1), y,
                         batch_dims=lengthscale.dim())


def _grid_objective(x, y, lengthscale, noise_sd, rule: str, logs_noise_in_var: bool):
    """``rule`` at each of the B points (lengthscale [B], noise_sd [B]): [B]."""
    if rule == "wrong_crps":
        return wrong_crps_objective(x, y, lengthscale, noise_sd)
    k_ff = _k_ff(x, lengthscale)
    noise_sq = noise_sd**2
    if rule == "nlml":
        return nlml_exact(k_ff, y, noise_sq)
    p = loo_exact(k_ff, y, noise_sq)
    var = p.cov + noise_sq[:, None] if logs_noise_in_var and rule == "logs" else p.cov
    score = crps_gaussian if rule == "crps" else logs_gaussian
    return score(p.mean, var, y, batch_dims=1)


def objective_surface(x, y, lengthscales, noise_sds, rule: str = "crps",
                      logs_noise_in_var: bool = True):
    """``rule`` (nlml, crps, logs or wrong_crps) on the whole (lengthscale x
    noise-sd) grid as one batched evaluation on x's device. Returns
    [len(lengthscales), len(noise_sds)]; no gradient."""
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}; expected one of {RULES}")
    ls, ns = _as_grid(lengthscales, x), _as_grid(noise_sds, x)
    gl, gs = ls.numel(), ns.numel()
    with torch.no_grad():
        z = _grid_objective(x, y, ls.repeat_interleave(gs), ns.repeat(gl), rule,
                            logs_noise_in_var)
    return z.reshape(gl, gs)
