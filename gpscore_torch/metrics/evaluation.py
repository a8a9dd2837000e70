"""Test-set evaluation metric suite (port of `gpscore/metrics/evaluation.py`).

Each (objective x replicate) in the reference records six numbers
(`kin40k-FULL-compare.py:276-292`): MSE, SMSE, test log score, test CRPS, MSLL
and 95% central coverage. :func:`evaluate_predictive` computes all six from a
diagonal predictive.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpscore_torch.scoring.rules import crps_gaussian, logs_gaussian


class EvalMetrics(NamedTuple):
    mse: torch.Tensor
    smse: torch.Tensor
    logs: torch.Tensor
    crps: torch.Tensor
    msll: torch.Tensor
    coverage95: torch.Tensor


def mse(mean, y):
    """`kin40k-FULL-compare.py:276`."""
    return torch.mean((mean.reshape(-1) - y.reshape(-1)) ** 2)


def smse(mean, y, y_train):
    """Standardized MSE: MSE / MSE of the train-mean predictor."""
    trivial = torch.mean((torch.mean(y_train) - y.reshape(-1)) ** 2)
    return mse(mean, y) / trivial


def msll(mean, var, y, y_train):
    """Mean standardized log loss: mean log score minus the log score of the
    trivial N(mean(y_train), var(y_train)) predictor (unbiased variance, as
    torch's ``.var()`` in the reference)."""
    mean, var, y = mean.reshape(-1), var.reshape(-1), y.reshape(-1)
    y_train = y_train.reshape(-1)
    m0 = torch.mean(y_train)
    v0 = torch.var(y_train, correction=1)
    per_site = (y - mean) ** 2 / (2.0 * var) + 0.5 * torch.log(var) + 0.5 * math.log(
        2.0 * math.pi
    )
    trivial = 0.5 * torch.log(2.0 * math.pi * v0) + (y - m0) ** 2 / (2.0 * v0)
    return torch.mean(per_site - trivial)


def coverage95(mean, var, y):
    """Fraction of test targets inside mu +/- 2 sigma."""
    mean, var, y = mean.reshape(-1), var.reshape(-1), y.reshape(-1)
    sd = torch.sqrt(var)
    inside = (y < mean + 2.0 * sd) & (y > mean - 2.0 * sd)
    return torch.mean(inside.to(mean.dtype))


def evaluate_predictive(mean, var, y, y_train) -> EvalMetrics:
    """All six reference metrics from a diagonal predictive."""
    return EvalMetrics(
        mse=mse(mean, y),
        smse=smse(mean, y, y_train),
        logs=logs_gaussian(mean, var, y),
        crps=crps_gaussian(mean, var, y),
        msll=msll(mean, var, y, y_train),
        coverage95=coverage95(mean, var, y),
    )
