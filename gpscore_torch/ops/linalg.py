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

The exact GP's two solve cores, :class:`LooSolveDiag` and
:class:`KfoldSolveBlocks` (`gpscore/ops/linalg.py:112-225`), are
``torch.autograd.Function``s with the closed-form adjoints of the JAX custom
VJPs: each saves only K^-1 and a = K^-1 y, never the factor chain.
"""

from __future__ import annotations

import torch

from gpscore_torch.utils.precision import matmul

_JITTER_LADDER = (0.0, 1e-6, 1e-4, 1e-2)


def chol_factor(A):
    """Lower Cholesky factor of SPD A. Where A is not SPD, the factor is NaN
    on and below the diagonal and 0 above it, as ``jnp.linalg.cholesky`` gives.
    The NaN enters by multiplication, so the gradient is NaN there too, as in
    JAX. Where autograd does not keep the factor it is marked in place: the
    factor is the one new tensor, which the fold-streamed cores count on at
    fold blocks of gigabytes."""
    L, info = torch.linalg.cholesky_ex(A)
    mark = torch.where(info > 0, torch.nan, 1.0).to(L.dtype)[..., None, None]
    if L.requires_grad:
        return (L * mark).tril()
    return L.mul_(mark).tril_()


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


def safe_cholesky(A, ladder=_JITTER_LADDER, batch_dims: int = 0):
    """Cholesky with escalating-jitter retry. Returns ``(L, ok)``; ``ok`` is
    False only if every rung failed (L is then NaN). The jitter is relative to
    the mean diagonal.

    Eager counterpart of the JAX ``lax.cond`` ladder: every rung is factored
    and ``torch.where`` keeps the first that succeeded, so nothing waits on
    the host. The NaN probe, the rung and ``ok`` are per element of the first
    ``batch_dims`` axes, as under ``jax.vmap`` of the JAX function (``ok``
    [*A.shape[:batch_dims]]); the stack after them (e.g. the folds of one
    restart) shares one rung, as the unvmapped JAX function's does.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    scale = torch.mean(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)[..., None, None]

    def failed(L):  # [*A.shape[:batch_dims]]: a NaN in the element's factor
        return torch.isnan(L).flatten(batch_dims).any(dim=-1)

    trail = [1] * (A.dim() - batch_dims)
    L = chol_factor(A + ladder[0] * scale * eye)
    for frac in ladder[1:]:
        L = torch.where(failed(L).reshape(*A.shape[:batch_dims], *trail),
                        chol_factor(A + frac * scale * eye), L)
    return L, torch.logical_not(failed(L))


def spd_inverse(A=None, *, L=None):
    """Materialized SPD inverse A^-1 = L^-T L^-1, from A or its factor L: one
    triangular solve against I, then one matmul. One form at every n (the JAX
    package switches to a GEMM-recursion inverse at n >= 2048, an XLA
    workaround). NaN where the factor failed."""
    if L is None:
        L = chol_factor(A)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = tri_solve(L, eye)
    return matmul(Linv.mT, Linv)


def _fold_view(M, fold_k: int):
    """The fold_k diagonal blocks of M [..., n, n] as a view [..., nb, nb, k]."""
    nb = M.shape[-1] // fold_k
    return torch.diagonal(M.reshape(*M.shape[:-2], fold_k, nb, fold_k, nb), dim1=-4, dim2=-2)


def _fold_blocks(M, fold_k: int):
    """The fold_k diagonal blocks [M]_bb of M [..., n, n], stacked [..., k, nb, nb]."""
    return _fold_view(M, fold_k).movedim(-1, -3)


def _block_diag(A, n: int):
    """The [..., n, n] block-diagonal matrix of the blocks A [..., k, nb, nb]:
    one batched write into zeros, no host sync and no loop over the batch, so
    a captured step can hold it (``torch.block_diag`` takes one matrix at a
    time)."""
    B = A.new_zeros((*A.shape[:-3], n, n))
    _fold_view(B, A.shape[-3]).copy_(A.movedim(-3, -1))
    return B


class LooSolveDiag(torch.autograd.Function):
    """(a, d) = (K^-1 y, diag(K^-1)) for SPD K [..., n, n] and y [..., n],
    the two ingredients of the LOO identities, with the closed-form backward
    of `gpscore/ops/linalg.py:112-162`:

        a = K^-1 y:       K_bar += -(K^-1 a_bar) a^T,   y_bar = K^-1 a_bar
        d = diag(K^-1):   K_bar += -(K^-1 * d_bar[None, :]) K^-1

    Only K^-1 and a are saved. An output that does not reach the loss gets a
    zero cotangent (``ctx.set_materialize_grads``, the default). Leading
    dimensions batch: each batch's solve and adjoint are its own."""

    @staticmethod
    def forward(ctx, K, y):
        Kinv = spd_inverse(K)
        a = matmul(Kinv, y[..., None])[..., 0]
        ctx.save_for_backward(Kinv, a)
        return a, torch.diagonal(Kinv, dim1=-2, dim2=-1).clone()

    @staticmethod
    def backward(ctx, a_bar, d_bar):
        Kinv, a = ctx.saved_tensors
        w = matmul(Kinv, a_bar[..., None])  # K^-1 a_bar [..., n, 1]
        K_bar = -matmul(w, a[..., None, :]) - matmul(Kinv * d_bar[..., None, :], Kinv)
        return K_bar, w[..., 0]


loo_solve_diag = LooSolveDiag.apply


class KfoldSolveBlocks(torch.autograd.Function):
    """(a, A) = (K^-1 y, the stacked diagonal blocks [K^-1]_bb [..., k, nb,
    nb]) for SPD K [..., n, n] and y [..., n], the two ingredients of the
    k-fold conditionals, with the closed-form backward of
    `gpscore/ops/linalg.py:165-225` (the block generalization of
    :class:`LooSolveDiag`'s):

        a = K^-1 y:       K_bar += -(K^-1 a_bar) a^T,   y_bar = K^-1 a_bar
        A_b = [K^-1]_bb:  K_bar += -K^-1 blockdiag(A_bar) K^-1

    Only K^-1 and a are saved. Raises ``ValueError`` unless fold_k divides n.
    Leading dimensions batch."""

    @staticmethod
    def forward(ctx, K, y, fold_k: int):
        n = K.shape[-1]
        if n % fold_k != 0:
            raise ValueError(f"n={n} not divisible by fold_k={fold_k}")
        Kinv = spd_inverse(K)
        a = matmul(Kinv, y.reshape(*y.shape[:-1], n, 1))[..., 0]
        ctx.save_for_backward(Kinv, a)
        return a, _fold_blocks(Kinv, fold_k).contiguous()

    @staticmethod
    def backward(ctx, a_bar, A_bar):
        Kinv, a = ctx.saved_tensors
        w = matmul(Kinv, a_bar[..., None])
        B = _block_diag(A_bar, Kinv.shape[-1])
        K_bar = -matmul(w, a[..., None, :]) - matmul(matmul(Kinv, B), Kinv)
        return K_bar, w[..., 0], None


kfold_solve_blocks = KfoldSolveBlocks.apply


def symmetric_sqrt(C):
    """Symmetric PSD square root U diag(s)^1/2 U^T, eigenvalues clamped at 0
    (`gpscore/ops/linalg.py:228-237`); only the energy score's
    ``sqrt_method="eigh"`` parity path uses it. ``torch.linalg.eigh`` raises
    on a CUDA input it cannot decompose (and waits on the host to find out),
    where ``jnp.linalg.eigh`` returns NaN."""
    s, U = torch.linalg.eigh(C)
    s = torch.clamp(s, min=0.0)
    return matmul(U * torch.sqrt(s)[..., None, :], U.mT)
