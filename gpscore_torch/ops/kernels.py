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

Every function takes a leading batch axis, the restarts or replicates of a
sweep: x [..., n, d], and leaves with a leading [B] (log_signal_sq [B],
log_length [B, d] for ARD or [B] for rbf and a batched ARD with one length).
A batch of leaves gives [B, n, m] from x [n, d] shared by every batch or x
[B, n, d]. Whether the leaves are batched is read off log_signal_sq, a
scalar unbatched.
"""

from __future__ import annotations

import torch

from gpscore_torch.ops.gram_cuda import ArdGram
from gpscore_torch.utils.precision import matmul_crit


def _as_tensor(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def per_batch(v, trailing: int):
    """A scalar leaf (or a Python number) as it is; a batched one [B] as
    [B, 1, ...] with ``trailing`` ones, to broadcast against [B, ...]
    values."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        return v.reshape(*v.shape, *([1] * trailing))
    return v


def _cross_sqdist(x, xp):
    """-(squared distance) as 2 x.x' - |x|^2 - |x'|^2 (the reference's
    expand-and-subtract trick), contraction in IEEE fp32."""
    res = 2.0 * matmul_crit(x, xp.mT)
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)  # [..., n, 1]
    xp_sq = torch.sum(xp * xp, dim=-1, keepdim=True).mT  # [..., 1, m]
    return res - x_sq - xp_sq


def rbf_gram(x, xp, log_signal_sq, log_length_sq):
    """Isotropic RBF: exp(log_signal_sq) * exp(-0.5 * d2 / exp(log_length_sq)).
    x: [..., n, d], xp: [..., m, d] -> [..., n, m]."""
    log_signal_sq = per_batch(_as_tensor(log_signal_sq, x), 2)
    log_length_sq = per_batch(_as_tensor(log_length_sq, x), 2)
    res = 0.5 * _cross_sqdist(x, xp) / torch.exp(log_length_sq)
    return torch.exp(log_signal_sq) * torch.exp(res)


def ard_gram(x, xp, log_signal_sq, log_length):
    """ARD RBF: inputs scaled per dimension by exp(-log_length), then the
    unit-length RBF. x: [..., n, d], xp: [..., m, d], log_length: [d] or
    scalar ([B, d] or [B, 1] batched)."""
    log_signal_sq = _as_tensor(log_signal_sq, x)
    log_length = _as_tensor(log_length, x)
    if log_length.dim() <= 1:
        inv_len = torch.exp(-log_length.reshape(1, -1))
    else:
        inv_len = torch.exp(-log_length).unsqueeze(-2)
    neg_d2 = _cross_sqdist(x * inv_len, xp * inv_len)
    return torch.exp(per_batch(log_signal_sq, 2)) * torch.exp(0.5 * neg_d2)


def kernel_diag(x, log_signal_sq):
    """diag K(x, x) = signal_sq for the stationary RBF/ARD kernels: [n], or
    [B, n] for batched leaves or x [B, n, d]."""
    sig = torch.exp(_as_tensor(log_signal_sq, x))
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) * per_batch(sig, 1)


def gram(x, xp, log_signal_sq, log_length, *, kind: str = "ard"):
    """Kernel-dispatching Gram entry point, through the Gram kernel."""
    if kind not in ("ard", "rbf"):
        raise ValueError(f"unknown kernel kind: {kind}")
    log_signal_sq = _as_tensor(log_signal_sq, x)
    log_length = _as_tensor(log_length, x)
    batched = log_signal_sq.dim() > 0
    if kind == "rbf":
        if batched:  # one squared length per batch: [B] -> [B, d]
            log_length = (0.5 * log_length)[..., None].expand(*log_length.shape, x.shape[-1])
        else:
            log_length = (0.5 * log_length).expand(x.shape[-1])
    elif batched and log_length.dim() == 1:  # one length per batch: [B] -> [B, 1]
        log_length = log_length[..., None]
    return ArdGram.apply(x, xp, log_signal_sq, log_length)
