"""Hyperparameters as a dataclass of tensors (port of `gpscore/utils/params.py`).

All scalar hyperparameters are log-parameterized, as in the JAX package:

- ``log_signal_sq``  sigma_k^2 = exp(.)
- ``log_length``     exp(.) is the per-dimension lengthscale for ``ard`` and the
                     *squared* lengthscale for the isotropic ``rbf``
- ``log_noise_sq``   sigma_noise^2 = exp(.)
- ``inducing``       FITC inducing inputs [m, d], or None for the exact GP
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

FIELDS = ("log_signal_sq", "log_length", "log_noise_sq", "inducing")


@dataclasses.dataclass
class GPParams:
    log_signal_sq: torch.Tensor  # scalar []
    log_length: torch.Tensor  # [d] for ARD, [] for isotropic rbf
    log_noise_sq: torch.Tensor  # scalar []
    inducing: Optional[torch.Tensor] = None  # [m, d] or None

    @property
    def signal_sq(self):
        return torch.exp(self.log_signal_sq)

    @property
    def noise_sq(self):
        return torch.exp(self.log_noise_sq)

    def replace(self, **kw) -> "GPParams":
        return dataclasses.replace(self, **kw)

    def leaves(self) -> dict:
        """The tensors that are present, by field name (``inducing`` may be None)."""
        return {f: getattr(self, f) for f in FIELDS if getattr(self, f) is not None}


def init_unit_params(
    d: int = 1, isotropic: bool = True, inducing=None, device="cpu"
) -> GPParams:
    """Unit init of the synthetic scripts: all log-params = 1.0."""
    dtype = torch.float32
    shape = () if isotropic else (d,)
    return GPParams(
        log_signal_sq=torch.ones((), dtype=dtype, device=device),
        log_length=torch.ones(shape, dtype=dtype, device=device),
        log_noise_sq=torch.ones((), dtype=dtype, device=device),
        inducing=inducing,
    )


def params_from_numpy(arrays: dict, device="cpu") -> GPParams:
    """GPParams from numpy arrays (or nested lists) keyed by field name, as
    float32 tensors on ``device``. ``inducing`` may be absent or None."""

    def conv(v):
        if v is None:
            return None
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return GPParams(**{f: conv(arrays.get(f)) for f in FIELDS})


def params_to_numpy(p: GPParams) -> dict:
    """Field name -> numpy array (None stays None)."""
    return {
        f: None if getattr(p, f) is None else getattr(p, f).detach().cpu().numpy()
        for f in FIELDS
    }
