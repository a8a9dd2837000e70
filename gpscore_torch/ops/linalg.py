"""Cholesky-centric dense linear algebra (port of `gpscore/ops/linalg.py`).

These go to ``torch.linalg`` (cuSOLVER and cuBLAS on the card); the JAX
package likewise left them to XLA, outside any Pallas kernel. Leading
dimensions batch (folds ride a leading [k, ...] axis instead of ``vmap``).

Failure semantics follow the JAX package: ``jnp.linalg.cholesky`` returns NaN
for a non-SPD input instead of raising, and the escalating-jitter retry
(:func:`safe_cholesky`) and ``fit_gd``'s NaN-masked update depend on that.
:func:`chol_factor` therefore uses ``torch.linalg.cholesky_ex`` (which neither
raises nor syncs with the host) and writes NaN into every factor whose
``info > 0``.
"""

from __future__ import annotations

import torch

_JITTER_LADDER = (0.0, 1e-6, 1e-4, 1e-2)


def chol_factor(A):
    """Lower Cholesky factor of SPD A. Where A is not SPD, the factor is NaN
    on and below the diagonal and 0 above it, as ``jnp.linalg.cholesky`` gives.
    The NaN enters by multiplication, so the gradient is NaN there too, as in
    JAX."""
    L, info = torch.linalg.cholesky_ex(A)
    lower = torch.ones_like(L, dtype=torch.bool).tril()
    failed = (info > 0)[..., None, None] & lower
    return L * torch.where(failed, torch.nan, torch.ones_like(L))


def tri_solve(L, B, *, lower: bool = True, trans: bool = False):
    """Solve L X = B (or L^T X = B with ``trans``) for triangular L."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=lower)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def chol_solve_from_factor(L, B):
    """A^{-1} B given A = L L^T."""
    return tri_solve(L, tri_solve(L, B), trans=True)


def chol_solve(B, A):
    """A^{-1} B for SPD A (argument order matches the reference's chol_solve)."""
    return chol_solve_from_factor(chol_factor(A), B)


def inv_diag_from_chol(L):
    """diag(A^{-1}) from A = L L^T: sum_k (L^{-1})_{ki}^2, one triangular solve."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = tri_solve(L, eye)
    return torch.sum(Linv * Linv, dim=-2)


def half_logdet(L):
    """0.5 * log det A = sum log diag(L)."""
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def safe_cholesky(A, ladder=_JITTER_LADDER):
    """Cholesky with escalating-jitter retry. Returns ``(L, ok)``; ``ok`` is
    False only if every rung failed (L is then NaN). The jitter is relative to
    the mean diagonal.

    Eager counterpart of the JAX ``lax.cond`` ladder: every rung is factored
    and ``torch.where`` keeps the first that succeeded, so nothing waits on
    the host.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    scale = torch.mean(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)[..., None, None]
    L = chol_factor(A + ladder[0] * scale * eye)
    for frac in ladder[1:]:
        bad = torch.any(torch.isnan(L))
        L = torch.where(bad, chol_factor(A + frac * scale * eye), L)
    ok = torch.logical_not(torch.any(torch.isnan(L)))
    return L, ok
