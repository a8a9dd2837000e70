"""The wide start of a large-n cell: unit parameters with the log lengths
raised by log(d / 8) / 2.

Copied from ``gpscore_torch/experiments/bench_wide.py:38-41`` (``wide_params``,
over ``gpscore_torch/utils/params.py:70-81``, ``init_unit_params`` with ARD
lengths), returning a dict of leaves as :func:`gpbench.frozen.data.unit_params`
does. At unit lengths and d = 90 the squared distances of standard-normal
inputs are ~180 (~24 scaled by the unit length), and K(x, x) is near the
identity: off its diagonal a median of ~5e-6 of the signal variance, nowhere
1%. Raised so, they are the d = 8 case's and K spans a range off its
diagonal (~0.14 to ~0.59 of the signal variance at n = 512).
"""

from __future__ import annotations

import math

import torch


def wide_params(d: int) -> dict:
    """Every log-parameter 1.0, the log lengths 1.0 + log(d / 8) / 2 (float32,
    on the CPU)."""
    one = torch.ones((), dtype=torch.float32)
    return {"log_signal_sq": one.clone(),
            "log_length": torch.ones(d) + 0.5 * math.log(d / 8.0),
            "log_noise_sq": one.clone()}
