"""In-place Gram -> K_hat^-1 pipeline in one n x n buffer (port of
`gpscore/ops/potri_inplace.py`, the fori stages).

LAPACK's ``potrf -> trtri -> lauum`` (= ``potri``) on one buffer ``W``,
which carries K_hat -> L -> L^-1 -> K_hat^-1:

1. :func:`khat_full`: the whole K_hat = K_ard(x) + noise I, one launch of the
   Gram kernel on the scaled inputs (`potri_inplace.py:240-290`).
2. :func:`chol_inplace`: left-looking blocked Cholesky with the half log-det
   (`:335-423`). W <- L, strict upper zero.
3. :func:`tri_inv_inplace`: blocked lower-triangular inversion, right to left
   (`:426-497`, `:146-173`). W <- X = L^-1, lower.
4. :func:`lauum_inplace`: K_hat^-1 = X^T X column panel by column panel,
   written lower and mirrored upper, so the result is the full symmetric
   inverse (`:558-633`, `:176-203`).

Each stage is a Python loop over panels of width ``block`` that updates views
of ``W`` in place; the last panel is ragged where ``block`` does not divide n,
so there is no padding and no mask (the JAX package pads to a multiple of the
block and masks, and its ``[:n, :n]`` block equals the result here). Peak
memory is the n x n buffer plus O(n * block) panel temporaries. The Schur
updates and the panel solves run in IEEE fp32 (``matmul_crit``: TF32 is off).

The unrolled/fori duality, the layout rules and the ``Dstack`` sidecar of the
JAX module exist for XLA's compiler and are not ported.

A failed leaf factor makes the result NaN, with no exception and no host sync
(:func:`gpscore_torch.ops.linalg.chol_factor`): every later panel reads it.
Not differentiable; the fused cores of :mod:`gpscore_torch.ops.loo_fused`
stream their backward off the returned inverse.
"""

from __future__ import annotations

import torch

from gpscore_torch.ops import gram_cuda, linalg
from gpscore_torch.utils.precision import matmul_crit


def check_storage(storage) -> None:
    """Only IEEE fp32 storage is ported."""
    if storage is not None and storage != torch.float32:
        raise NotImplementedError(
            f"storage={storage} is not ported: only fp32 buffers (ROADMAP.md, queue 1, "
            "item 2: the precision modes)"
        )


def khat_full(log_signal_sq, log_length, log_noise_sq, x):
    """K_hat = K_ard(x) + noise I, [n, n]: one Gram kernel launch on CUDA."""
    xs = gram_cuda.scale_inputs(x, log_length)
    W = gram_cuda.gram_fwd(xs, xs, torch.exp(log_signal_sq))
    W.diagonal().add_(torch.exp(log_noise_sq))
    return W


def chol_inplace(W, block: int):
    """W <- its lower Cholesky factor L (strict upper set to 0), left-looking;
    returns the half log-det sum log diag L (a 0-d tensor).

    The left update of a panel is applied one earlier panel at a time, as a
    right-looking factorization applies it, not as one GEMM over all s
    columns: an fp32 GEMM keeps one running sum per entry along its inner
    dimension, and that single product left the factor at n = 30,720 an
    order of magnitude farther from a float64 one than cuSOLVER's potrf
    (``chip_smoke.py`` phase 8 prints both against float64)."""
    n = W.shape[0]
    hld = W.new_zeros(())
    for s in range(0, n, block):
        e = min(s + block, n)
        P = W[s:, s:e]  # column panel: K_hat there, minus its left update
        for c in range(0, s, block):
            P.addmm_(W[s:, c:c + block], W[s:e, c:c + block].T, alpha=-1.0)
        Lkk = linalg.chol_factor(P[: e - s])
        hld = hld + torch.sum(torch.log(torch.diagonal(Lkk)))
        if e < n:
            # L[e:, s:e] = P[e:] L_kk^-T
            P[e - s:] = torch.linalg.solve_triangular(Lkk.T, P[e - s:], upper=True, left=False)
        P[: e - s] = Lkk
        W[:s, s:e].zero_()
    return hld


def tri_inv_inplace(W, block: int) -> None:
    """W: L (lower, zero strict upper) -> X = L^-1 (lower), right to left:
    X[t:, s:t] = -X[t:, t:] L[t:, s:t] X_ss, the product over t: summed a
    panel at a time (see :func:`chol_inplace`)."""
    n = W.shape[0]
    for s in reversed(range(0, n, block)):
        t = min(s + block, n)
        eye = torch.eye(t - s, dtype=W.dtype, device=W.device)
        Xss = torch.linalg.solve_triangular(W[s:t, s:t], eye, upper=False).tril_()
        if t < n:
            # The original L column, read before it is overwritten: row block r
            # writes its rows of column panel s while the row blocks below it
            # still read them.
            Lcol = W[t:, s:t].clone()
            for r0 in range(t, n, block):
                r1 = min(r0 + block, n)
                # X[r, t:r1] is all of row block r's trailing X (X is lower).
                acc = matmul_crit(W[r0:r1, t:t + block], Lcol[:block])
                for c in range(t + block, r1, block):
                    acc.addmm_(W[r0:r1, c:c + block], Lcol[c - t:c - t + block])
                W[r0:r1, s:t].addmm_(acc, Xss, beta=0.0, alpha=-1.0)
        W[s:t, s:t] = Xss


def lauum_inplace(W, block: int) -> None:
    """W: X = L^-1 (lower, zero strict upper) -> K_hat^-1 = X^T X, full
    symmetric.

    Column panel s takes B = X[s:, s:]^T X[s:, s:e] from row blocks r >= s
    (X[r, s:r1] is row block r's nonzero part), reading only rows >= s of
    the lower triangle. B is written after the whole sum (the sum reads
    column panel s itself) into the lower panel, and its transpose into row
    band s right of the diagonal block: rows that no later panel reads."""
    n = W.shape[0]
    for s in range(0, n, block):
        e = min(s + block, n)
        B = W.new_zeros((n - s, e - s))
        for r0 in range(s, n, block):
            r1 = min(r0 + block, n)
            B[: r1 - s].addmm_(W[r0:r1, s:r1].T, W[r0:r1, s:e])
        W[s:, s:e] = B
        if e < n:
            W[s:e, e:] = B[e - s:].T


def ard_gram_inverse_inplace(log_signal_sq, log_length, log_noise_sq, x, block: int = 2048,
                             return_half_logdet: bool = False, storage=None):
    """K_hat^-1 [n, n] for K_hat = K_ard(x) + noise I, full symmetric; with
    ``return_half_logdet`` also the half log-det of K_hat."""
    check_storage(storage)
    with torch.no_grad():
        W = khat_full(log_signal_sq, log_length, log_noise_sq, x)
        hld = chol_inplace(W, block)
        tri_inv_inplace(W, block)
        lauum_inplace(W, block)
    return (W, hld) if return_half_logdet else W


def ard_gram_chol_inplace(log_signal_sq, log_length, log_noise_sq, x, block: int = 2048,
                          storage=None):
    """(L, half log-det) of K_hat, stage 1 alone: for consumers that solve
    against K_hat rather than use its inverse (the NLML primal)."""
    check_storage(storage)
    with torch.no_grad():
        W = khat_full(log_signal_sq, log_length, log_noise_sq, x)
        return W, chol_inplace(W, block)
