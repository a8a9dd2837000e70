"""CRPS-as-area illustration data (port of `gpscore/analysis/crps_illustration.py`).

CRPS is the integral of (F(t) - H(t - y))^2 between the forecast CDF F and
the Heaviside CDF of the observation (`crps-plot.R:3-36` draws it for a
probabilistic N(mu, sigma^2) forecast and a deterministic one). This module
gives the curves as tensors; :mod:`gpscore_torch.analysis.plots` draws them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_SQRT2 = math.sqrt(2.0)


class CRPSCurves(NamedTuple):
    t: torch.Tensor  # evaluation grid
    forecast_cdf: torch.Tensor  # F(t) of the probabilistic forecast
    deterministic_cdf: torch.Tensor  # step CDF of a point forecast at mu
    obs_cdf: torch.Tensor  # Heaviside H(t - y) of the observation
    integrand: torch.Tensor  # (F - H)^2, whose area is the CRPS
    crps_numeric: torch.Tensor  # trapezoidal integral of the integrand


def crps_illustration(
    mu: float = 0.0,
    sigma: float = 1.0,
    y: float = 1.0,
    t_lo: float = -4.0,
    t_hi: float = 4.0,
    num: int = 801,
    device="cuda",
) -> CRPSCurves:
    """The curves of the CRPS area figure on ``num`` points of [t_lo, t_hi],
    float32 on ``device``: forecast CDF, the point forecast's and the
    observation's step CDFs, and the squared difference with its area."""
    t = torch.linspace(t_lo, t_hi, num, dtype=torch.float32, device=device)
    F = 0.5 * (1.0 + torch.special.erf((t - mu) / (sigma * _SQRT2)))
    det = (t >= mu).to(torch.float32)
    H = (t >= y).to(torch.float32)
    integrand = (F - H) ** 2
    return CRPSCurves(t, F, det, H, integrand, torch.trapezoid(integrand, t))
