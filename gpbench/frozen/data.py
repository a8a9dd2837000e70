"""Inputs and initial parameters of the cells, made from the run's seed.

Copied from the program's generators; each function names its origin:

- :func:`synthesize_kin40k_like` from ``gpscore_torch/data/kin40k.py:39-66``
  (the KIN40K-shaped stand-in; the published KIN40K file is not in the
  repository), with the seed as its argument;
- :func:`kin40k_replicate_split` from ``gpscore_torch/data/kin40k.py:130-156``
  (numpy arrays, the training rows only);
- :func:`large_n_data` from ``gpscore_torch/experiments/large_n.py:52-64``
  (``make_data``, without the test rows, which no cell evaluates);
- :func:`init_rand_params` from ``gpscore_torch/utils/params.py:79-116``,
  returning a dict of leaves.

Seeds: numpy takes any non-negative integer; a ``torch.Generator`` takes the
seed modulo 2**63.
"""

from __future__ import annotations

import numpy as np
import torch


def torch_seed(seed: int) -> int:
    return int(seed) % (2 ** 63)


def synthesize_kin40k_like(seed: int, n_pool: int = 10_000, n_test: int = 5_000, d: int = 8):
    """(train_x [n_pool, d], train_y [n_pool]) float32: a smooth nonlinear
    response (the endpoint distance of a 4-link arm) plus noise, standardized."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, size=(n_pool + n_test, d)).astype(np.float32)
    angles = np.cumsum(X[:, :4] * np.pi, axis=1)
    lengths = 0.5 + 0.5 * np.abs(X[:, 4:8])
    ex = np.sum(lengths * np.cos(angles), axis=1)
    ey = np.sum(lengths * np.sin(angles), axis=1)
    y = np.sqrt(ex ** 2 + ey ** 2).astype(np.float32)
    y = y + 0.05 * rng.standard_normal(n_pool + n_test).astype(np.float32)
    y = (y - y.mean()) / y.std()
    return X[:n_pool], y[:n_pool]


def kin40k_replicate_split(train_x, train_y, replicate: int, n_subsample: int = 500,
                           n_va: int = 300):
    """The training rows of replicate ``replicate``: seed replicate * 100,
    n_subsample + n_va pool rows without replacement, n_va of them carved out
    for validation. Returns (x [n_subsample, d], y [n_subsample])."""
    rng = np.random.default_rng(replicate * 100)
    sam = rng.choice(train_x.shape[0], size=n_subsample + n_va, replace=False)
    full_x, full_y = train_x[sam], train_y[sam]
    va_idx = rng.choice(full_x.shape[0], size=n_va, replace=False)
    mask = np.ones(full_x.shape[0], dtype=bool)
    mask[va_idx] = False
    return np.ascontiguousarray(full_x[mask]), np.ascontiguousarray(full_y[mask])


def large_n_data(n: int, d: int, seed: int):
    """(x [n, d], y [n]) float32 on the CPU: a smooth function of d
    standard-normal inputs plus 0.1 noise."""
    gen = torch.Generator().manual_seed(torch_seed(seed))
    x = torch.randn((n, d), generator=gen)
    y = (torch.sin(x[:, 0]) + 0.5 * torch.cos(2.0 * x[:, 1 % d]) + 0.3 * x[:, 2 % d]
         + 0.1 * torch.randn((n,), generator=gen))
    return x, y


def init_rand_params(generator: torch.Generator, d: int, num_inducing: int = 0,
                     unit_scalars: bool = False, inducing_init: str = "uniform",
                     batch=None) -> dict:
    """log lengths ~ U(0, 1)^d; log signal and log noise ~ U(0, 1), or 1.0
    with ``unit_scalars``; inducing points ~ U(0, 1), or N(0, 1) with
    ``inducing_init="normal"``; drawn in that order, all ``batch`` restarts
    at once. float32 on the generator's device."""
    opts = dict(dtype=torch.float32, device=generator.device, generator=generator)
    lead = () if batch is None else (batch,)
    out = {}
    log_length = torch.rand((*lead, d), **opts)
    if unit_scalars:
        out["log_signal_sq"] = torch.ones(lead, dtype=torch.float32, device=generator.device)
        out["log_noise_sq"] = torch.ones(lead, dtype=torch.float32, device=generator.device)
    else:
        out["log_signal_sq"] = torch.rand(lead, **opts)
        out["log_noise_sq"] = torch.rand(lead, **opts)
    out["log_length"] = log_length
    if num_inducing > 0:
        draw = torch.randn if inducing_init == "normal" else torch.rand
        out["inducing"] = draw((*lead, num_inducing, d), **opts)
    return out


def unit_params(d: int) -> dict:
    """Unit initial parameters of the large-n driver: every log-parameter 1.0
    (``gpscore_torch/utils/params.py:64-76``, ``init_unit_params``, ARD)."""
    one = torch.ones((), dtype=torch.float32)
    return {"log_signal_sq": one.clone(), "log_length": torch.ones(d), "log_noise_sq": one.clone()}
