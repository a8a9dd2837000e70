"""Squared-exponential kernel Gram construction (port of `gpscore/ops/kernels.py`).

Two length parameterizations, as in the reference:

- ``rbf_gram``: isotropic RBF where ``exp(log_length)`` is the **squared**
  lengthscale dividing the squared distance.
- ``ard_gram``: ARD RBF where ``exp(log_length)`` is the per-dimension
  lengthscale dividing the inputs.

``rbf_gram`` and ``ard_gram`` are the plain cross-term forms, differentiated by
autograd. :func:`gram`, the entry point every model uses, goes through the
Gram kernel (:class:`gpscore_torch.ops.gram_cuda.ArdGram`): the CUDA C++
kernels on a CUDA tensor, their plain version on a CPU tensor. The isotropic
kernel rides the same kernel, since rbf with log squared length b equals ARD
with log length b/2 in every dimension (`gpscore/fit/objectives.py:47-62`).
"""

from __future__ import annotations

import torch

from gpscore_torch.ops.gram_cuda import ArdGram
from gpscore_torch.utils.precision import matmul_crit


def _as_tensor(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _cross_sqdist(x, xp):
    """-(squared distance) as 2 x.x' - |x|^2 - |x'|^2 (the reference's
    expand-and-subtract trick), contraction in IEEE fp32."""
    res = 2.0 * matmul_crit(x, xp.T)
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)  # [n, 1]
    xp_sq = torch.sum(xp * xp, dim=-1, keepdim=True).T  # [1, m]
    return res - x_sq - xp_sq


def rbf_gram(x, xp, log_signal_sq, log_length_sq):
    """Isotropic RBF: exp(log_signal_sq) * exp(-0.5 * d2 / exp(log_length_sq)).
    x: [n, d], xp: [m, d] -> [n, m]."""
    log_signal_sq = _as_tensor(log_signal_sq, x)
    log_length_sq = _as_tensor(log_length_sq, x)
    res = 0.5 * _cross_sqdist(x, xp) / torch.exp(log_length_sq)
    return torch.exp(log_signal_sq) * torch.exp(res)


def ard_gram(x, xp, log_signal_sq, log_length):
    """ARD RBF: inputs scaled per dimension by exp(-log_length), then the
    unit-length RBF. x: [n, d], xp: [m, d], log_length: [d] or scalar."""
    log_signal_sq = _as_tensor(log_signal_sq, x)
    inv_len = torch.exp(-_as_tensor(log_length, x).reshape(1, -1))
    neg_d2 = _cross_sqdist(x * inv_len, xp * inv_len)
    return torch.exp(log_signal_sq) * torch.exp(0.5 * neg_d2)


def kernel_diag(x, log_signal_sq):
    """diag K(x, x) = signal_sq for the stationary RBF/ARD kernels. [n]."""
    sig = torch.exp(_as_tensor(log_signal_sq, x))
    return torch.ones((x.shape[0],), dtype=x.dtype, device=x.device) * sig


def gram(x, xp, log_signal_sq, log_length, *, kind: str = "ard"):
    """Kernel-dispatching Gram entry point, through the Gram kernel."""
    if kind not in ("ard", "rbf"):
        raise ValueError(f"unknown kernel kind: {kind}")
    log_signal_sq = _as_tensor(log_signal_sq, x)
    log_length = _as_tensor(log_length, x)
    if kind == "rbf":
        log_length = (0.5 * log_length).expand(x.shape[1])
    return ArdGram.apply(x, xp, log_signal_sq, log_length)
