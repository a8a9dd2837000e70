"""Scoring-rule sensitivity curves (port of `gpscore/analysis/sensitivity.py`).

How CRPS, the log score, DSS and the energy score respond to a normalized
error in the predictive mean, in its variance and, for the multivariate
rules, in its correlation (`relative-change-NEW.R:80-214`). Each sweep the
JAX package vmaps is a leading batch axis here: a curve is one batched
evaluation over [sweep values, data], the truth prepended to the sweep
where a curve is normalized by it.

A ``torch.Generator`` takes the place of each PRNG key, and the work runs on
its device. JAX's threefry draws cannot be replayed, so every function also
takes its standard normals as ``eps``, laid out as the JAX function draws
them from its key (each docstring names the draw); the tests hand JAX's own
draws across. Common random numbers are kept where JAX keeps them: one set
of draws per datum, shared by every sweep value.
"""

from __future__ import annotations

import torch

from gpscore_torch.ops import linalg
from gpscore_torch.scoring.rules import crps_gaussian, dss, energy_score, logs_gaussian


def _normal(shape, generator):
    """Standard normals of ``shape`` from ``generator``, on its device."""
    if generator is None:
        raise ValueError("give a generator or the normals (eps)")
    return torch.randn(shape, dtype=torch.float32, device=generator.device, generator=generator)


def _values(v, device):
    """Sweep values as float32 [S] on ``device``."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)


def _site_curve(score, generator, values, n, eps, var_sweep):
    """Mean ``score`` of N(v, 1) (or N(0, v)) forecasts per sweep value v
    against targets y ~ N(0, 1) [n]: ``eps``, or JAX's ``normal(key, (n,))``
    drawn from ``generator``."""
    y = eps if eps is not None else _normal((n,), generator)
    v = _values(values, y.device)[:, None].expand(-1, y.shape[0])
    ones = torch.ones_like(v)
    mean, var = (0.0 * ones, v * ones) if var_sweep else (v * ones, ones)
    return score(mean, var, y, batch_dims=1)


def crps_mean_error_curve(generator, pre_mu, n: int = 10_000, *, eps=None):
    """Mean CRPS of N(mu, 1) forecasts against y ~ N(0, 1), over mu
    (`relative-change-NEW.R:81`). ``eps``: the targets [n]."""
    return _site_curve(crps_gaussian, generator, pre_mu, n, eps, var_sweep=False)


def crps_var_error_curve(generator, pre_sigma_sq, n: int = 10_000, *, eps=None):
    """Mean CRPS of N(0, v) forecasts, over v. ``eps``: the targets [n]."""
    return _site_curve(crps_gaussian, generator, pre_sigma_sq, n, eps, var_sweep=True)


def logs_mean_error_curve(generator, pre_mu, n: int = 10_000, *, eps=None):
    """Mean log score of N(mu, 1) forecasts, over mu. ``eps``: the targets [n]."""
    return _site_curve(logs_gaussian, generator, pre_mu, n, eps, var_sweep=False)


def logs_var_error_curve(generator, pre_sigma_sq, n: int = 10_000, *, eps=None):
    """Mean log score of N(0, v) forecasts, over v. ``eps``: the targets [n]."""
    return _site_curve(logs_gaussian, generator, pre_sigma_sq, n, eps, var_sweep=True)


def _equicorr_cov(rho, dim: int = 2, scale=1.0, device=None):
    """Equicorrelated covariance (R ``replace_corr``, `relative-change-NEW.R:63-75`):
    diagonal ``scale``, off-diagonal ``rho * scale`` (R's ``replace_diag(k)``
    at scale k, `:50-62`). ``rho`` and ``scale`` are numbers or tensors [S]
    (then [S, dim, dim])."""
    rho, scale = (torch.as_tensor(v, dtype=torch.float32, device=device) for v in (rho, scale))
    eye = torch.eye(dim, dtype=torch.float32, device=rho.device)
    return scale[..., None, None] * (eye + rho[..., None, None] * (1.0 - eye))


def _equicorr_data(generator, rho, num_data: int, dim: int, scale=1.0, *, eps=None):
    """num_data draws from N(0, equicorr(rho) * scale) through the Cholesky
    factor. ``eps``: the normals [num_data, dim], JAX's
    ``normal(key, (num_data, dim))``."""
    if eps is None:
        eps = _normal((num_data, dim), generator)
    L = torch.linalg.cholesky(_equicorr_cov(rho, dim, scale, eps.device))
    return eps @ L.mT


def _es_r_style(mean_vec, cov, y, eps, beta: float = 1.0):
    """Monte-Carlo energy score with the R script's distance kernel.

    `relative-change-NEW.R:32-49` measures sample distances as
    ``sum_d |x1_d - x2_d|^beta`` (the L1 distance at beta = 1), not the
    Euclidean ``||.||^beta`` of :func:`gpscore_torch.scoring.rules.energy_score`;
    this variant exists to reproduce the R curves. Normalization as in R: the
    first term a mean over the draws, the second over the whole S x S pair
    matrix (`:45-47`). Leading dimensions batch: mean_vec and y [..., dim],
    cov [..., dim, dim]. ``eps = (e1, e2)``, each [..., S, dim]: JAX's
    ``split(key)`` -> k1, k2, then ``normal(k1, (S, dim))``."""
    root = linalg.chol_factor(cov).mT
    x1 = mean_vec[..., None, :] + eps[0] @ root
    x2 = mean_vec[..., None, :] + eps[1] @ root
    first = torch.mean(torch.sum(torch.abs(x1 - y[..., None, :]) ** beta, dim=-1), dim=-1)
    pair = torch.abs(x1[..., :, None, 0] - x2[..., None, :, 0]) ** beta
    for k in range(1, cov.shape[-1]):  # sum over the dimensions, one [S, S] plane at a time
        pair = pair + torch.abs(x1[..., :, None, k] - x2[..., None, :, k]) ** beta
    return first - 0.5 * torch.mean(pair, dim=(-2, -1))


def _relative(scores):
    """(score - truth) / truth, the truth first in ``scores``."""
    return (scores[1:] - scores[0]) / scores[0]


def _mean_dss(mean, cov, data):
    """Mean DSS over data [N, dim] per sweep value: mean [S, 1, dim] or a
    number, cov [S, 1, dim, dim] or [dim, dim] -> [S]."""
    return torch.mean(dss(mean, cov, data), dim=-1)


def dss_mean_error_curve(generator, pre_mu, rho: float = 0.5, num_data: int = 500,
                         dim: int = 2, true_sigma_sq: float = 1.0, *, eps=None):
    """Relative change in mean DSS as the predictive mean sweeps pre_mu
    (`relative-change-NEW.R:105-115`): data ~ N(0, replace_diag(sigma_sq)),
    normalized by the truth at mu = 0. ``eps``: the data's normals
    [num_data, dim] (:func:`_equicorr_data`)."""
    data = _equicorr_data(generator, rho, num_data, dim, true_sigma_sq, eps=eps)
    C = _equicorr_cov(rho, dim, true_sigma_sq, data.device)
    mus = torch.cat([data.new_zeros(1), _values(pre_mu, data.device)])
    return _relative(_mean_dss(mus[:, None, None].expand(-1, 1, dim), C, data))


def dss_var_error_curve(generator, pre_sigma_sq, rho: float = 0.5, num_data: int = 500,
                        dim: int = 2, true_sigma_sq: float = 1.0, *, eps=None):
    """Relative change in mean DSS as the predictive variance sweeps
    pre_sigma_sq with the correlation held at rho (`relative-change-NEW.R:118-128`:
    covariance replace_diag(k) = k equicorr(rho)), normalized by the truth at
    k = true_sigma_sq. ``eps``: the data's normals [num_data, dim]."""
    data = _equicorr_data(generator, rho, num_data, dim, true_sigma_sq, eps=eps)
    ks = torch.cat([data.new_full((1,), true_sigma_sq), _values(pre_sigma_sq, data.device)])
    C = _equicorr_cov(rho, dim, ks, data.device)[:, None]
    return _relative(_mean_dss(data.new_zeros(dim), C, data))


def _es_normals(generator, num_data, dim, num_sim, eps):
    """(data normals [N, dim], e1 [N, S, dim], e2 [N, S, dim]): JAX's
    ``k_data, k_es = split(key)``, ``normal(k_data, (N, dim))``, and per datum
    i, ``split(split(k_es, N)[i])`` -> k1, k2, ``normal(k1, (S, dim))``."""
    if eps is not None:
        return eps
    return (_normal((num_data, dim), generator), _normal((num_data, num_sim, dim), generator),
            _normal((num_data, num_sim, dim), generator))


def es_mean_error_curve(generator, pre_mu, rho: float = 0.5, num_data: int = 500,
                        dim: int = 2, num_sim: int = 100, true_sigma_sq: float = 1.0, *,
                        eps=None):
    """Relative change in mean energy score (the R script's L1 kernel) as the
    predictive mean sweeps pre_mu (`relative-change-NEW.R:165-175`), each
    datum's draws shared by every mu. ``eps``: (data normals, e1, e2) as
    :func:`_es_normals` lays them out."""
    d_eps, e1, e2 = _es_normals(generator, num_data, dim, num_sim, eps)
    data = _equicorr_data(None, rho, num_data, dim, true_sigma_sq, eps=d_eps)
    C = _equicorr_cov(rho, dim, true_sigma_sq, data.device)
    mus = torch.cat([data.new_zeros(1), _values(pre_mu, data.device)])
    m = mus[:, None, None].expand(-1, 1, dim)  # [S, 1, dim] against the data [N, dim]
    scores = _es_r_style(m, C, data, (e1, e2))
    return _relative(torch.mean(scores, dim=-1))


def es_var_error_curve(generator, pre_sigma_sq, rho: float = 0.5, num_data: int = 500,
                       dim: int = 2, num_sim: int = 100, true_sigma_sq: float = 1.0, *,
                       eps=None):
    """Relative change in mean energy score as the predictive variance
    sweeps pre_sigma_sq (`relative-change-NEW.R:178-188`), covariance
    replace_diag(k). ``eps``: as :func:`es_mean_error_curve`'s."""
    d_eps, e1, e2 = _es_normals(generator, num_data, dim, num_sim, eps)
    data = _equicorr_data(None, rho, num_data, dim, true_sigma_sq, eps=d_eps)
    ks = torch.cat([data.new_full((1,), true_sigma_sq), _values(pre_sigma_sq, data.device)])
    C = _equicorr_cov(rho, dim, ks, data.device)[:, None]  # [S, 1, dim, dim]
    scores = _es_r_style(data.new_zeros(dim), C, data, (e1, e2))
    return _relative(torch.mean(scores, dim=-1))


def dss_correlation_curve(generator, true_rho, rho_range, num_data: int = 500,
                          dim: int = 2, *, eps=None):
    """Relative change in mean DSS as the predictive correlation sweeps
    rho_range, for data generated at true_rho (`relative-change-NEW.R:131-144`).
    ``eps``: the data's normals [num_data, dim]."""
    data = _equicorr_data(generator, true_rho, num_data, dim, eps=eps)
    rhos = torch.cat([data.new_full((1,), true_rho), _values(rho_range, data.device)])
    C = _equicorr_cov(rhos, dim, device=data.device)[:, None]
    return _relative(_mean_dss(data.new_zeros(dim), C, data))


def es_correlation_curve(generator, true_rho, rho_range, num_data: int = 200,
                         dim: int = 2, num_sim: int = 100, *, eps=None):
    """Relative change in mean energy score (the package's Euclidean one,
    :func:`~gpscore_torch.scoring.rules.energy_score`) as the predictive
    correlation sweeps rho_range (`relative-change-NEW.R:190-203`): one
    batched call over [rho, datum], whose jitter rung is each element's own
    (``batch_dims=2``). ``eps``: as :func:`es_mean_error_curve`'s."""
    d_eps, e1, e2 = _es_normals(generator, num_data, dim, num_sim, eps)
    data = _equicorr_data(None, true_rho, num_data, dim, eps=d_eps)
    rhos = torch.cat([data.new_full((1,), true_rho), _values(rho_range, data.device)])
    C = _equicorr_cov(rhos, dim, device=data.device)[:, None]
    C = C.expand(-1, data.shape[0], dim, dim)  # [rho, datum, dim, dim]
    scores = energy_score(data.new_zeros(dim), C, data, num_sim=num_sim, eps=(e1, e2),
                          batch_dims=2)
    return _relative(torch.mean(scores, dim=-1))


def _family_eps(eps, i):
    if eps is None:
        return None
    return tuple(e[i] for e in eps) if isinstance(eps, (tuple, list)) else eps[i]


def dss_correlation_family(generator, true_rhos, rho_range, num_data: int = 500,
                           dim: int = 2, *, eps=None):
    """DSS correlation curves, one per true correlation, fresh data at each
    (`relative-change-NEW.R:137-144`). Returns [len(true_rhos), len(rho_range)].
    ``eps``: [len(true_rhos), num_data, dim], row i JAX's draw from
    ``fold_in(key, i)``."""
    return torch.stack([
        dss_correlation_curve(generator, r, rho_range, num_data, dim, eps=_family_eps(eps, i))
        for i, r in enumerate(true_rhos)])


def es_correlation_family(generator, true_rhos, rho_range, num_data: int = 200,
                          dim: int = 2, num_sim: int = 100, *, eps=None):
    """Energy-score correlation curves, one per true correlation
    (`relative-change-NEW.R:196-203`). Returns [len(true_rhos),
    len(rho_range)]. ``eps``: :func:`es_correlation_curve`'s three, each with
    a leading [len(true_rhos)] axis, row i from ``fold_in(key, i)``."""
    return torch.stack([
        es_correlation_curve(generator, r, rho_range, num_data, dim, num_sim,
                             eps=_family_eps(eps, i))
        for i, r in enumerate(true_rhos)])
