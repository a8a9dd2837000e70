"""Proper scoring rules for Gaussian predictive distributions (port of
`gpscore/scoring/rules.py`).

All rules are negatively oriented (smaller is better) and differentiable:

- CRPS        `SIMPLE-DATA FULL-comapre.py:76-84`
- log score   `SIMPLE-DATA FULL-comapre.py:68-73`
- DSS         `SIMPLE-DATA FULL-comapre.py:87-92`, in covariance and in
              precision form
- energy score `kin40k-FULL-compare.py:70-101`, Monte-Carlo, in covariance
              and in precision form, and its core on pre-drawn samples
- k-fold CRPS `KIN40K-COMPARE-ALL-FITC-20.py:709-714`
- interval score: Gneiting & Raftery (2007) eq. 43

The block rules take leading dimensions as folds and return one score per
block. The site rules (CRPS, log score, interval score) average over every
site by default; with ``batch_dims=1`` the first axis is a batch of restarts
or replicates ([R, n] against y [n] or [R, n]) and they return one score per
batch, [R]. ``crps_kfold`` sums over its fold axis and keeps any before it.

The energy-score samplers draw their standard normals from a
``torch.Generator`` (on the data's device), or take them as ``eps``; the
draws are not JAX's threefry draws, so the tests hand JAX's normals across.
A batch of R restarts draws [R, k, ...] normals at once from the one
generator.
"""

from __future__ import annotations

import math

import torch

from gpscore_torch.ops import linalg
from gpscore_torch.utils.precision import matmul

_SQRT2 = math.sqrt(2.0)
_SQRT_PI = math.sqrt(math.pi)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _std_normal_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def _std_normal_pdf(z):
    return _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


def _crps_per_site(mean, var, y):
    sigma = torch.sqrt(var)
    z = (y - mean) / sigma
    return sigma * (
        z * (2.0 * _std_normal_cdf(z) - 1.0) + 2.0 * _std_normal_pdf(z) - 1.0 / _SQRT_PI
    )


def _sites_mean(per_site, batch_dims: int):
    """The mean over every axis after the first ``batch_dims``."""
    if batch_dims == 0:
        return torch.mean(per_site)
    return torch.mean(per_site.reshape(*per_site.shape[:batch_dims], -1), dim=-1)


def _flat(mean, var, y, batch_dims: int):
    """All sites in one axis (unbatched), or the batch's shape, y shared by
    every batch or one per batch."""
    if batch_dims == 0:
        return mean.reshape(-1), var.reshape(-1), y.reshape(-1)
    shared = y.numel() != mean.numel()
    return mean, var, y.reshape(mean.shape[batch_dims:] if shared else mean.shape)


def crps_gaussian(mean, var, y, batch_dims: int = 0):
    """Mean closed-form Gaussian CRPS over all sites:
    sigma * [ z (2 Phi(z) - 1) + 2 phi(z) - 1/sqrt(pi) ],  z = (y - mu)/sigma."""
    return _sites_mean(_crps_per_site(*_flat(mean, var, y, batch_dims)), batch_dims)


def logs_gaussian(mean, var, y, batch_dims: int = 0):
    """Mean Gaussian negative log predictive density:
    (y - mu)^2 / (2 sigma^2) + log sigma + 0.5 log 2pi."""
    mean, var, y = _flat(mean, var, y, batch_dims)
    per_site = (y - mean) ** 2 / (2.0 * var) + 0.5 * torch.log(var) + _HALF_LOG_2PI
    return _sites_mean(per_site, batch_dims)


def _safe_norm_pow(sq, beta):
    """||.||^beta from squared norms with a finite gradient at 0: d/dx sqrt(x)
    is infinite at 0, and Monte-Carlo draws can collide to fp32 zero, so the
    distance is floored at ~1e-6."""
    d = torch.sqrt(torch.clamp(sq, min=1e-12))
    return d if beta == 1.0 else d**beta


def energy_score_core(z, zp, r, num_sim: int, beta: float):
    """ES estimate from pre-drawn samples z, z' [..., S, n] and r = mu - y
    [..., n]; leading dimensions batch (one score per fold):

        ES = mean_i ||z_i - r||^beta - 0.5 sum_{i,j} ||z_i - z'_j||^beta / (S (S - 1)).
    """
    zz = torch.sum(z * z, dim=-1)
    pp = torch.sum(zp * zp, dim=-1)
    cross = matmul(z, zp.mT)
    sq = torch.clamp(zz[..., :, None] + pp[..., None, :] - 2.0 * cross, min=0.0)
    z_minus_zp = torch.sum(_safe_norm_pow(sq, beta), dim=(-2, -1)) / (num_sim * (num_sim - 1))
    dz = z - r[..., None, :]
    z_minus_y = torch.mean(_safe_norm_pow(torch.sum(dz * dz, dim=-1), beta), dim=-1)
    return z_minus_y - 0.5 * z_minus_zp


def dss(mean, cov, y):
    """Dawid–Sebastiani score of a multivariate-Gaussian block, mean and y
    [..., n], cov [..., n, n]:

        0.5 n log 2pi + 0.5 log det C + 0.5 (y - m)^T C^-1 (y - m).
    """
    n = y.shape[-1]
    r = (y - mean)[..., None]
    L = linalg.chol_factor(cov)
    quad = 0.5 * torch.sum(r * linalg.chol_solve_from_factor(L, r), dim=(-2, -1))
    return 0.5 * n * math.log(2.0 * math.pi) + linalg.half_logdet(L) + quad


def dss_precision(mean, chol_prec, y):
    """DSS of a Gaussian given the lower Cholesky factor La of its precision
    (the k-fold block A = [K_hat^-1]_bb = La La^T): log det C =
    -2 sum log diag(La) and (y - m)^T C^-1 (y - m) = ||La^T (y - m)||^2, so
    neither an inverse nor a second factor is needed."""
    n = y.shape[-1]
    w = matmul(chol_prec.mT, (y - mean)[..., None])
    quad = 0.5 * torch.sum(w * w, dim=(-2, -1))
    return 0.5 * n * math.log(2.0 * math.pi) - linalg.half_logdet(chol_prec) + quad


def _normals(shape, like, generator, eps):
    """Two standard-normal sets of ``shape``: ``eps`` as given, or drawn."""
    if eps is not None:
        return eps
    opts = dict(dtype=like.dtype, device=like.device, generator=generator)
    return torch.randn(shape, **opts), torch.randn(shape, **opts)


def energy_score(
    mean, cov, y, num_sim: int = 300, beta: float = 1.0, sqrt_method: str = "chol",
    *, generator=None, eps=None, batch_dims: int = 0,
):
    """Monte-Carlo energy score of a multivariate-Gaussian block (mean, y
    [..., n], cov [..., n, n]; reference ``ES``, `kin40k-FULL-compare.py:70-101`):

        ES = mean_i ||z_i - (mu - y)||^beta - 0.5 sum_ij ||z_i - z'_j||^beta / (S (S - 1))

    with z, z' ~ N(0, C) drawn as eps root(C)^T: through the Cholesky factor
    with the jitter ladder of :func:`~gpscore_torch.ops.linalg.safe_cholesky`
    (one rung for the whole stack, or one for each element of the first
    ``batch_dims`` axes, as ``jax.vmap`` over them takes it), or, with
    ``sqrt_method="eigh"``, through the reference's symmetric square root.
    ``eps = (e, e')``, each [..., S, n], fixes the normals (JAX draws
    ``normal(k1, (S, n))``)."""
    if sqrt_method not in ("chol", "eigh"):
        raise ValueError(f"sqrt_method must be 'chol' or 'eigh', got {sqrt_method!r}")
    n = y.shape[-1]
    r = mean - y
    if sqrt_method == "chol":
        L, _ = linalg.safe_cholesky(cov, batch_dims=batch_dims)
        root_cov = L.mT  # z = eps L^T  =>  cov(z) = L L^T = C
    else:
        root_cov = linalg.symmetric_sqrt(cov)
    e, ep = _normals((*cov.shape[:-2], num_sim, n), cov, generator, eps)
    z = matmul(e, root_cov)
    zp = matmul(ep, root_cov)
    return energy_score_core(z, zp, r, num_sim, beta)


def energy_score_precision(
    mean, chol_prec, y, num_sim: int = 300, beta: float = 1.0, *, generator=None, eps=None
):
    """Energy score of N(mean, C) with C = (La La^T)^-1 given the precision
    factor La [..., nb, nb]: z = La^-T eps has covariance C, one triangular
    solve per draw set. ``eps = (e, e')``, each [..., nb, S], fixes the
    normals; JAX draws them per fold as ``split(key, k)``, then
    ``split`` -> k1, k2, then ``normal(k1, (nb, S))``."""
    nb = y.shape[-1]
    r = mean - y
    e, ep = _normals((*chol_prec.shape[:-2], nb, num_sim), chol_prec, generator, eps)
    z = linalg.tri_solve(chol_prec, e, trans=True).mT  # [..., S, nb]
    zp = linalg.tri_solve(chol_prec, ep, trans=True).mT
    return energy_score_core(z, zp, r, num_sim, beta)


def crps_kfold(mean_b, var_b, y_b):
    """"kc" objective: CRPS per fold on the diagonal of the block conditional,
    summed over folds. mean_b/var_b/y_b: [k, nb] ([R, k, nb] -> [R])."""
    return torch.sum(torch.mean(_crps_per_site(mean_b, var_b, y_b), dim=-1), dim=-1)


def interval_score(mean, var, y, alpha: float = 0.05, batch_dims: int = 0):
    """Mean central (1-alpha) interval score (Gneiting & Raftery 2007, eq. 43):

        S = (u - l) + (2/alpha) (l - y) 1{y < l} + (2/alpha) (y - u) 1{y > u}

    with l, u the alpha/2 and 1-alpha/2 Gaussian quantiles.
    """
    mean, var, y = _flat(mean, var, y, batch_dims)
    sigma = torch.sqrt(var)
    # Phi^-1(1 - alpha/2) = sqrt(2) erfinv(1 - alpha).
    q = _SQRT2 * torch.erfinv(torch.tensor(1.0 - alpha, dtype=torch.float64)).item()
    lo = mean - q * sigma
    hi = mean + q * sigma
    width = hi - lo
    below = (2.0 / alpha) * torch.clamp(lo - y, min=0.0)
    above = (2.0 / alpha) * torch.clamp(y - hi, min=0.0)
    return _sites_mean(width + below + above, batch_dims)
