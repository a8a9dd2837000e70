"""Exact-GP predictive containers (port of `gpscore/models/exact.py`).

Only the :class:`Gaussian` container that the FITC model returns is ported so
far; the exact-GP model itself is a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Gaussian(NamedTuple):
    """A (possibly diagonal) Gaussian predictive: mean [n] and cov, which is
    [n] (diagonal variances) or [n, n] (full covariance)."""

    mean: torch.Tensor
    cov: torch.Tensor
