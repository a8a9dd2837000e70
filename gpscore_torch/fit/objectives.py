"""Differentiable training objectives: scoring rule ∘ predictive ∘ kernel
(port of `gpscore/fit/objectives.py`: the exact GP at small n and FITC).

Each objective is ``loss(params, x, y, generator=None, eps=None) -> scalar``.
``generator`` (a ``torch.Generator`` on the data's device) and ``eps`` feed
only the ``es`` rule; every objective accepts them so that they share one
signature.

Rules:
- ``crps``  CRPS on the LOO predictive (`SIMPLE-DATA FULL-comapre.py:204-213`)
- ``logs``  log score on the LOO predictive, with the reference's FITC variance
            "correction" (`KIN40K-COMPARE-ALL-FITC-20.py:441-446`)
- ``nlml``  negative log marginal likelihood
- ``dss``   sum of Dawid–Sebastiani scores over k-fold block conditionals
- ``es``    sum of Monte-Carlo energy scores over k-fold blocks
- ``kc``    sum of per-fold CRPS on block-conditional diagonals
- ``interval`` mean interval score on the LOO predictive

The exact GP (``model="exact"``) runs the dense path below
``_FUSED_LOO_MIN_N``: K_ff = gram(x, x) through the Gram kernel, then one
Cholesky and the closed-form solve cores of :mod:`gpscore_torch.ops.linalg`.
From ``_FUSED_LOO_MIN_N`` on, as in the JAX package, crps, logs and interval
go through the fused LOO core and nlml through the fused NLML core
(:mod:`gpscore_torch.ops.loo_fused`: one n x n buffer, the gradient streamed
through the Gram backward kernels), and the fold rules dss, es and kc
through the fold-streamed cores (:mod:`gpscore_torch.ops.fold_stream`: one
fold at a time off that buffer).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from gpscore_torch.models import exact as exact_mod
from gpscore_torch.models import fitc as fitc_mod
from gpscore_torch.ops import linalg
from gpscore_torch.ops.kernels import gram
from gpscore_torch.scoring import rules

OBJECTIVE_RULES = ("crps", "logs", "nlml", "dss", "es", "kc", "interval")

# From this n on, the exact objectives take the fused large-n cores. On an
# NVIDIA H100 80GB HBM3 (700 W) the dense crps and dss steps are the faster
# ones below it (3.2 and 5.9 ms at n = 2048 against the fused 4.0 and 7.4-8.0;
# 7.1 and 12.3-12.7 at 3072 against 7.5 and 13.0-13.2), the two paths level at
# 4096 (12.3 and 20.7-21.0 against 11.9-12.2 and 19.6, the fused one at 3.2-3.5
# n^2 * 4 B of peak memory against 8.0) and the fused ones faster above (5120:
# 19.0-22.4 and 30.3 against 22.6 and 36.5; 8192: 51.8 and 73 against 73 and
# 111) (``bench_ceiling --crossover``, two runs; the JAX package's 8192 is a
# TPU's). Read at call time: tests lower it.
_FUSED_LOO_MIN_N = 4096


def _fused_params(params, kernel: str, d: int):
    """Parameters as the fused ARD cores take them (`gpscore/fit/objectives.py:47-62`):
    the isotropic rbf with log squared length b is ARD with log length b/2 in
    each of the d dimensions; ``expand``'s backward sums the per-dimension
    length gradient back into the scalar."""
    if kernel == "ard":
        return params
    return params.replace(log_length=(0.5 * params.log_length).expand(d))


def make_objective(
    rule: str,
    model: str = "exact",
    kernel: str = "ard",
    fold_k: int = 4,
    num_sim: int = 300,
    es_beta: float = 1.0,
    interval_alpha: float = 0.05,
    block: Optional[int] = None,
) -> Callable:
    """Build ``loss(params, x, y, generator=None, eps=None) -> scalar``.

    ``block`` is the fused cores' panel width at large n (None: their
    ``auto_block``).

    For ``es``, ``eps`` fixes the standard normals of the two sample sets;
    otherwise they are drawn from ``generator``. FITC:
    ``eps = ((e1, e2), (e1p, e2p))``, shapes as in
    :func:`gpscore_torch.models.fitc.lowrank_fold_sample`. Exact:
    ``eps = (e, e')``, each [fold_k, nb, num_sim], as in
    :func:`gpscore_torch.scoring.rules.energy_score_precision`; the
    fold-streamed core takes them side by side, z | z', and needs ``eps`` or
    a ``generator``.
    """
    if rule not in OBJECTIVE_RULES:
        raise ValueError(f"unknown rule {rule!r}; expected one of {OBJECTIVE_RULES}")
    if model not in ("exact", "fitc"):
        raise ValueError(f"unknown model {model!r}")
    exact = model == "exact"

    def _fused(x):
        return exact and x.shape[0] >= _FUSED_LOO_MIN_N

    def _k_ff(params, x):
        return gram(x, x, params.log_signal_sq, params.log_length, kind=kernel)

    def _fold_stats(params, x, y, want_inv_diag=False):
        return exact_mod.kfold_stats_fused(x, y, _fused_params(params, kernel, x.shape[1]),
                                           fold_k, want_inv_diag, block)

    def _loo(params, x, y):
        if _fused(x):
            return exact_mod.loo_exact_fused(x, y, _fused_params(params, kernel, x.shape[1]),
                                             block)
        if exact:
            return exact_mod.loo_exact(_k_ff(params, x), y, params.noise_sq)
        return fitc_mod.loo_fitc(
            x, y, params, kind=kernel, variance_correction=(rule == "logs")
        )

    def _kfold(params, x, y):
        if exact:
            return exact_mod.kfold_exact_precision(_k_ff(params, x), y, params.noise_sq, fold_k)
        return fitc_mod.kfold_fitc_lowrank(x, y, params, fold_k, kind=kernel)

    if rule == "crps":

        def loss(params, x, y, generator=None, eps=None):
            p = _loo(params, x, y)
            return rules.crps_gaussian(p.mean, p.cov, y)

    elif rule == "logs":

        def loss(params, x, y, generator=None, eps=None):
            p = _loo(params, x, y)
            return rules.logs_gaussian(p.mean, p.cov, y)

    elif rule == "interval":

        def loss(params, x, y, generator=None, eps=None):
            p = _loo(params, x, y)
            return rules.interval_score(p.mean, p.cov, y, alpha=interval_alpha)

    elif rule == "nlml":

        def loss(params, x, y, generator=None, eps=None):
            if _fused(x):
                return exact_mod.nlml_exact_fused(
                    x, y, _fused_params(params, kernel, x.shape[1]), block)
            if exact:
                return exact_mod.nlml_exact(_k_ff(params, x), y, params.noise_sq)
            return fitc_mod.nlml_fitc(x, y, params, kind=kernel)

    elif rule == "dss":

        def loss(params, x, y, generator=None, eps=None):
            if _fused(x):
                # DSS_b = nb/2 log 2pi - hld_b + e_b^T a_b / 2: hld is the half
                # log-det of the fold precision, and the quadratic r^T A r
                # with r = e collapses since A e = a_b.
                stats, a_b, _ = _fold_stats(params, x, y)
                return (0.5 * a_b.numel() * math.log(2.0 * math.pi)
                        - torch.sum(stats.half_logdet) + 0.5 * torch.sum(stats.e * a_b))
            p = _kfold(params, x, y)
            y_b = y.reshape(p.mean.shape)
            if exact:
                return torch.sum(rules.dss_precision(p.mean, p.chol_prec, y_b))
            nb = y_b.shape[1]
            r = y_b - p.mean
            per_fold = (
                0.5 * nb * math.log(2.0 * math.pi)
                + 0.5 * fitc_mod.lowrank_fold_logdet_cov(p)
                + 0.5 * fitc_mod.lowrank_fold_quad(p, r)
            )
            return torch.sum(per_fold)

    elif rule == "es":

        def loss(params, x, y, generator=None, eps=None):
            if _fused(x):
                return exact_mod.kfold_es_fused(
                    x, y, _fused_params(params, kernel, x.shape[1]), fold_k, num_sim, es_beta,
                    block, generator, None if eps is None else torch.cat(eps, dim=-1))
            p = _kfold(params, x, y)
            y_b = y.reshape(p.mean.shape)
            if exact:
                return torch.sum(rules.energy_score_precision(
                    p.mean, p.chol_prec, y_b, num_sim, es_beta, generator=generator, eps=eps))
            eps_z, eps_zp = (None, None) if eps is None else eps
            z = fitc_mod.lowrank_fold_sample(p, num_sim, generator=generator, eps=eps_z)
            zp = fitc_mod.lowrank_fold_sample(p, num_sim, generator=generator, eps=eps_zp)
            r = p.mean - y_b
            return torch.sum(rules.energy_score_core(z, zp, r, num_sim, es_beta))

    elif rule == "kc":

        def loss(params, x, y, generator=None, eps=None):
            if _fused(x):
                stats, _, y_b = _fold_stats(params, x, y, want_inv_diag=True)
                return rules.crps_kfold(y_b - stats.e, stats.inv_diag, y_b)
            p = _kfold(params, x, y)
            y_b = y.reshape(p.mean.shape)
            if exact:
                # var = diag(A^-1) straight from the factor, no inverse formed
                var_b = linalg.inv_diag_from_chol(p.chol_prec)
            else:
                var_b = fitc_mod.lowrank_fold_cov_diag(p)
            return rules.crps_kfold(p.mean, var_b, y_b)

    loss.__name__ = f"{rule}_{model}_objective"
    return loss
