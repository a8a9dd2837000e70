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
memory is the n x n buffer plus O(n * block) panel temporaries.

Precision (:mod:`gpscore_torch.utils.precision`): the Cholesky's left update
goes through ``matmul_crit``, the tri-inverse and lauum products through
``matmul`` (`potri_inplace.py:371-391`, `:471-481`, `:598-610`); the leaf
factors and the panel solves are IEEE fp32 cuSOLVER/cuBLAS calls in every
mode. With ``storage`` bfloat16 or float16 (the "bf16"/"f16" modes) ``W`` is
2-byte: K_hat is written into it by the Gram kernel's 2-byte form (one
rounding of the fp32 value plus noise), and every stored block is rounded
once from an fp32 accumulator (JAX's one rounding per block, `:341-352`):
the Cholesky accumulates a column panel's left update in an fp32 copy of the
panel (a view of a 2-byte ``W`` cannot hold fp32), factors and solves it in
fp32 and writes it back once; the tri-inverse and lauum sum in fp32 and
store once. The products of stored blocks are one native 2-byte pass with
fp32 accumulation (``matmul_acc32``).

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
from gpscore_torch.utils.precision import TWO_BYTE, acc_dtype, addmm_, matmul, upcast


def _storage(storage) -> torch.dtype:
    """The n x n buffer's dtype: float32 (None), bfloat16 or float16."""
    st = torch.float32 if storage is None else storage
    if st != torch.float32 and st not in TWO_BYTE:
        raise TypeError(f"storage must be float32, bfloat16 or float16, got {storage}")
    return st


def khat_full(log_signal_sq, log_length, log_noise_sq, x, storage=None):
    """K_hat = K_ard(x) + noise I, [n, n] in ``storage`` (None: float32): one
    Gram kernel launch on CUDA. A 2-byte K_hat takes the noise inside the
    kernel, before its one rounding."""
    st = _storage(storage)
    xs = gram_cuda.scale_inputs(x, log_length)
    if st != torch.float32:
        return gram_cuda.gram_fwd(xs, xs, torch.exp(log_signal_sq), out_dtype=st,
                                  diag_add=torch.exp(log_noise_sq))
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
    stored = W.dtype in TWO_BYTE
    hld = W.new_zeros((), dtype=acc_dtype(W.dtype))
    for s in range(0, n, block):
        e = min(s + block, n)
        # Column panel: K_hat there, minus its left update; fp32 in any case.
        P = upcast(W[s:, s:e])
        for c in range(0, s, block):
            addmm_(P, W[s:, c:c + block], W[s:e, c:c + block].T, alpha=-1.0, crit=True)
        Lkk = linalg.chol_factor(P[: e - s])
        hld = hld + torch.sum(torch.log(torch.diagonal(Lkk)))
        if e < n:
            # L[e:, s:e] = P[e:] L_kk^-T (in place in the fp32 copy of a 2-byte panel)
            if stored:
                torch.linalg.solve_triangular(Lkk.T, P[e - s:], upper=True, left=False,
                                              out=P[e - s:])
            else:
                P[e - s:] = torch.linalg.solve_triangular(Lkk.T, P[e - s:], upper=True,
                                                          left=False)
        P[: e - s] = Lkk
        if stored:
            W[s:, s:e] = P  # the panel's one rounding
        W[:s, s:e].zero_()
    return hld


def tri_inv_inplace(W, block: int) -> None:
    """W: L (lower, zero strict upper) -> X = L^-1 (lower), right to left:
    X[t:, s:t] = -X[t:, t:] L[t:, s:t] X_ss, the product over t: summed a
    panel at a time (see :func:`chol_inplace`)."""
    n = W.shape[0]
    stored = W.dtype in TWO_BYTE
    for s in reversed(range(0, n, block)):
        t = min(s + block, n)
        Lss = upcast(W[s:t, s:t])
        eye = torch.eye(t - s, dtype=Lss.dtype, device=W.device)
        Xss = torch.linalg.solve_triangular(Lss, eye, upper=False).tril_()
        if t < n:
            # The original L column, read before it is overwritten: row block r
            # writes its rows of column panel s while the row blocks below it
            # still read them.
            Lcol = W[t:, s:t].clone()
            for r0 in range(t, n, block):
                r1 = min(r0 + block, n)
                # X[r, t:r1] is all of row block r's trailing X (X is lower).
                acc = matmul(W[r0:r1, t:t + block], Lcol[:block])
                for c in range(t + block, r1, block):
                    addmm_(acc, W[r0:r1, c:c + block], Lcol[c - t:c - t + block])
                if stored:
                    W[r0:r1, s:t] = matmul(acc, Xss).neg_()  # one rounding
                else:
                    addmm_(W[r0:r1, s:t], acc, Xss, beta=0.0, alpha=-1.0)
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
        B = W.new_zeros((n - s, e - s), dtype=acc_dtype(W.dtype))
        for r0 in range(s, n, block):
            r1 = min(r0 + block, n)
            addmm_(B[: r1 - s], W[r0:r1, s:r1].T, W[r0:r1, s:e])
        W[s:, s:e] = B  # in a 2-byte W, B's one rounding
        if e < n:
            W[s:e, e:] = B[e - s:].T


def ard_gram_inverse_inplace(log_signal_sq, log_length, log_noise_sq, x, block: int = 2048,
                             return_half_logdet: bool = False, storage=None):
    """K_hat^-1 [n, n] for K_hat = K_ard(x) + noise I, full symmetric, in
    ``storage`` (None: float32; bfloat16 or float16 for the 2-byte modes);
    with ``return_half_logdet`` also the half log-det of K_hat (fp32)."""
    with torch.no_grad():
        W = khat_full(log_signal_sq, log_length, log_noise_sq, x, storage)
        hld = chol_inplace(W, block)
        tri_inv_inplace(W, block)
        lauum_inplace(W, block)
    return (W, hld) if return_half_logdet else W


def ard_gram_chol_inplace(log_signal_sq, log_length, log_noise_sq, x, block: int = 2048,
                          storage=None):
    """(L, half log-det) of K_hat, stage 1 alone, L in ``storage``: for
    consumers that solve against K_hat rather than use its inverse (the NLML
    primal, the large-n predictive)."""
    with torch.no_grad():
        W = khat_full(log_signal_sq, log_length, log_noise_sq, x, storage)
        return W, chol_inplace(W, block)


def tri_solve_stored(L, B, block: int, trans: bool = False):
    """L^-1 B (or L^-T B with ``trans``) for a lower-triangular L [n, n] in
    any storage dtype and an fp32 B [n, c], by blocked substitution: each
    diagonal [block, block] block upcast to fp32 for the triangular solve
    (cuBLAS has no 2-byte trsm), each off-diagonal panel upcast one panel at
    a time for its fp32 product. Returns a new fp32 [n, c]."""
    n = L.shape[0]
    X = B.clone()
    starts = list(range(0, n, block))
    for s in (reversed(starts) if trans else starts):
        e = min(s + block, n)
        if trans:  # X[s:e] = L[s:e, s:e]^-T (B[s:e] - L[e:, s:e]^T X[e:])
            if e < n:
                addmm_(X[s:e], upcast(L[e:, s:e]).T, X[e:], alpha=-1.0)
            X[s:e] = torch.linalg.solve_triangular(upcast(L[s:e, s:e]).T, X[s:e], upper=True)
        else:  # X[s:e] = L[s:e, s:e]^-1 (B[s:e] - L[s:e, :s] X[:s])
            if s > 0:
                addmm_(X[s:e], upcast(L[s:e, :s]), X[:s], alpha=-1.0)
            X[s:e] = torch.linalg.solve_triangular(upcast(L[s:e, s:e]), X[s:e], upper=False)
    return X


def ard_khat_matmul_streamed(log_signal_sq, log_length, log_noise_sq, x, V, block: int):
    """K_hat V [n, c] (fp32) for K_hat = K_ard(x) + noise I, without an n x n
    buffer (`potri_inplace.py:293-332`): the row panels of K_hat are
    recomputed from x, [block, n] fp32 at a time, by the Gram kernel, and
    multiplied in IEEE fp32 in every mode (JAX pins HIGHEST there, `:329`):
    the exact operator beside a 2-byte-stored factor, for the refinement of
    the large-n predictive."""
    n = x.shape[0]
    xs = gram_cuda.scale_inputs(x, log_length)
    sig, noise = torch.exp(log_signal_sq), torch.exp(log_noise_sq)
    out = V.new_empty((n, V.shape[1]))
    with torch.no_grad():
        for r0 in range(0, n, block):
            r1 = min(r0 + block, n)
            P = gram_cuda.gram_fwd(xs[r0:r1], xs, sig)
            P[:, r0:r1].diagonal().add_(noise)
            out[r0:r1] = torch.matmul(P, V)
    return out
