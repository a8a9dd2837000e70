"""Synthetic 1-D GP data (port of `gpscore/data/synthetic.py`).

The protocol of `SIMPLE-DATA FULL-comapre.py:161-181`:

- full_x = 2 * N(0, 1) draws, num_total = 450 (120 train / 300 test / 30 val)
- y ~ N(0, K_rbf(l^2 = 1, k^2 = 1) + 0.3^2 I), drawn jointly over all 450 points
  through the Cholesky factor
- contiguous split train / test / val

The normals come from a ``torch.Generator`` or are given (``eps_x``,
``eps_y``, each [num_total]); the tests pass the JAX package's threefry draws
that way and get its split.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gpscore_torch.ops import linalg
from gpscore_torch.ops.kernels import rbf_gram
from gpscore_torch.utils.precision import matmul


class SyntheticSplit(NamedTuple):
    train_x: torch.Tensor  # [num_train, 1]
    train_y: torch.Tensor  # [num_train]
    test_x: torch.Tensor
    test_y: torch.Tensor
    va_x: torch.Tensor
    va_y: torch.Tensor


def sample_synthetic_1d(
    generator: Optional[torch.Generator] = None,
    num_train: int = 120,
    num_test: int = 300,
    num_va: int = 30,
    true_sigma_noise: float = 0.3,
    true_log_l_sq: float = 0.0,  # log(1.0): reference `:170`
    true_log_k_sq: float = 0.0,  # log(1.0): reference `:171`
    *,
    eps_x=None,
    eps_y=None,
) -> SyntheticSplit:
    """One replicate's split, on the generator's device (or ``eps_x``'s)."""
    num_total = num_train + num_test + num_va
    if eps_x is None or eps_y is None:
        device = "cpu" if generator is None else generator.device
        opts = dict(dtype=torch.float32, device=device, generator=generator)
        eps_x = torch.randn((num_total,), **opts)
        eps_y = torch.randn((num_total,), **opts)
    X = (2.0 * eps_x).reshape(num_total, 1)
    eye = torch.eye(num_total, dtype=X.dtype, device=X.device)
    K = rbf_gram(X, X, true_log_k_sq, true_log_l_sq) + (true_sigma_noise**2) * eye
    full_y = matmul(linalg.chol_factor(K), eps_y.reshape(num_total, 1))[:, 0]
    tr = slice(0, num_train)
    te = slice(num_train, num_train + num_test)
    va = slice(num_train + num_test, num_total)
    return SyntheticSplit(X[tr], full_y[tr], X[te], full_y[te], X[va], full_y[va])
