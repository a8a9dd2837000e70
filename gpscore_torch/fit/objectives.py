"""Differentiable training objectives: scoring rule ∘ predictive ∘ kernel
(port of `gpscore/fit/objectives.py`, FITC model).

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

The exact-GP model (``model="exact"``) is a later slice and raises.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from gpscore_torch.models import fitc as fitc_mod
from gpscore_torch.scoring import rules

OBJECTIVE_RULES = ("crps", "logs", "nlml", "dss", "es", "kc", "interval")


def make_objective(
    rule: str,
    model: str = "exact",
    kernel: str = "ard",
    fold_k: int = 4,
    num_sim: int = 300,
    es_beta: float = 1.0,
    interval_alpha: float = 0.05,
) -> Callable:
    """Build ``loss(params, x, y, generator=None, eps=None) -> scalar``.

    For ``es``, ``eps = ((e1, e2), (e1p, e2p))`` fixes the standard normals of
    the two sample sets (shapes as in
    :func:`gpscore_torch.models.fitc.lowrank_fold_sample`); otherwise they are
    drawn from ``generator``.
    """
    if rule not in OBJECTIVE_RULES:
        raise ValueError(f"unknown rule {rule!r}; expected one of {OBJECTIVE_RULES}")
    if model == "exact":
        raise NotImplementedError("the exact-GP objectives are not ported yet")
    if model != "fitc":
        raise ValueError(f"unknown model {model!r}")

    def _loo(params, x, y):
        return fitc_mod.loo_fitc(
            x, y, params, kind=kernel, variance_correction=(rule == "logs")
        )

    def _kfold(params, x, y):
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
            return fitc_mod.nlml_fitc(x, y, params, kind=kernel)

    elif rule == "dss":

        def loss(params, x, y, generator=None, eps=None):
            p = _kfold(params, x, y)
            y_b = y.reshape(p.mean.shape)
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
            p = _kfold(params, x, y)
            y_b = y.reshape(p.mean.shape)
            eps_z, eps_zp = (None, None) if eps is None else eps
            z = fitc_mod.lowrank_fold_sample(p, num_sim, generator=generator, eps=eps_z)
            zp = fitc_mod.lowrank_fold_sample(p, num_sim, generator=generator, eps=eps_zp)
            r = p.mean - y_b
            return torch.sum(rules.energy_score_core(z, zp, r, num_sim, es_beta))

    elif rule == "kc":

        def loss(params, x, y, generator=None, eps=None):
            p = _kfold(params, x, y)
            y_b = y.reshape(p.mean.shape)
            return rules.crps_kfold(p.mean, fitc_mod.lowrank_fold_cov_diag(p), y_b)

    loss.__name__ = f"{rule}_{model}_objective"
    return loss
