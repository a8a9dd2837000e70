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

The FITC model's small factor-and-solve pairs go through
:func:`chol_solve_small`: on a card, for m up to CHOL_SMALL_MAX_M, one
hand-written kernel for the factor and the solve and one for their
closed-form VJP (:class:`CholSolveSmall`, ``csrc/chol_small.cu``); elsewhere
the library chain of :func:`chol_factor` and the triangular solves.
"""

from __future__ import annotations

import math

import torch

from gpscore_torch.ops import _build
from gpscore_torch.utils import profiling
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


# The fused small factor-and-solve (csrc/chol_small.cu), in blocks of
# CHOL_SMALL_THREADS threads (kCsThreads). CHOL_SMALL_MAX_M is the largest m
# the kernels take (kCsMaxM: a warp's lanes hold the factor's rows) and the
# largest that chol_solve_small sends them: on an NVIDIA H100 80GB HBM3 the
# pair beat the library chain at m = 20 and 32, and a shared-memory build
# that took m = 64 lost to it there (PERF.md, the pair alone).
CHOL_SMALL_MAX_M = 32
CHOL_SMALL_THREADS = 256
# chol_solve_small's calls by path: "fused" (the kernels), "library" (the chain).
CHOL_SMALL = {"fused": 0, "library": 0}


def chol_small_tile_rows(k: int) -> int:
    """Columns of B a tile of the kernels takes, one a thread: the block, or
    the whole warps that k needs."""
    return min(CHOL_SMALL_THREADS, max(32, -(-k // 32) * 32))


def _chol_small_launch(name, arrays, m, k, full):
    """Launch the kernel ``name`` on ``arrays`` ([batch, ., m] tensors or
    None, in the entry point's order) through :func:`_build.launch`."""
    first = arrays[0]
    if first.dtype not in _build.DTYPES or any(
            a is not None and (a.dtype != first.dtype or a.device != first.device)
            for a in arrays):
        raise TypeError(f"{name} takes float32 or float64 CUDA tensors of one dtype")
    if not 1 <= m <= CHOL_SMALL_MAX_M:
        raise ValueError(f"{name} takes 1 <= m <= {CHOL_SMALL_MAX_M}, got m = {m}")
    fn = _build.entry(_build.load_library(), name, first.dtype)
    ptrs = [None if a is None else _build.Batched(a, a.stride(0)) for a in arrays]
    args = (*ptrs, m, k, int(full), chol_small_tile_rows(k))
    with torch.cuda.device(first.device):
        _build.launch(fn, first.shape[0], lambda size: (*args, size),
                      torch.cuda.current_stream().cuda_stream)


def _chol_small_fwd_cuda(A, Bt, full):
    """(L, X^T) from the forward kernel; A [..., m, m], Bt = B^T [..., k, m]."""
    *lead, k, m = Bt.shape
    if A.shape != (*lead, m, m):
        raise ValueError(f"chol_small takes A [..., m, m] and B [..., m, k] of the same leading "
                         f"dimensions, got {tuple(A.shape)} and {tuple(Bt.mT.shape)}")
    A3 = A.reshape(-1, m, m).contiguous()
    Bt3 = Bt.reshape(-1, k, m).contiguous()
    L, Xt = torch.empty_like(A3), torch.empty_like(Bt3)
    _chol_small_launch("chol_small_fwd", (A3, Bt3, L, Xt), m, k, full)
    return L.reshape(*lead, m, m), Xt.reshape(*lead, k, m)


def _chol_small_bwd_cuda(L, Xt, L_bar, Xbar_t, full):
    """(A_bar, B_bar^T or None) from the backward kernel."""
    *lead, k, m = Xt.shape
    L3, Xt3 = L.reshape(-1, m, m), Xt.reshape(-1, k, m)
    Lb = None if L_bar is None else L_bar.reshape(-1, m, m).contiguous()
    Xb = None if Xbar_t is None else Xbar_t.reshape(-1, k, m).contiguous()
    A_bar = torch.empty_like(L3)
    Bb = None if Xb is None else torch.empty_like(Xt3)
    _chol_small_launch("chol_small_bwd", (L3, Xt3, Lb, Xb, A_bar, Bb), m, k, full)
    return A_bar.reshape(*lead, m, m), None if Bb is None else Bb.reshape(*lead, k, m)


def _chol_small_bwd_plain(L, Xt, L_bar, Xbar_t, full):
    """The backward kernel's formulas in plain torch (csrc/chol_small.cu):
    B_bar = L^-T X_bar (full: L^-T L^-1 X_bar), S = B_bar X^T,
    G = tril(L_bar) - tril(S) (full: tril(L_bar)),
    Y = L^-T Phi(tril(L^T G)) L^-1 (Phi halves the diagonal),
    A_bar = (Y + Y^T) / 2 (full: minus (S + S^T) / 2)."""
    G = torch.zeros_like(L) if L_bar is None else L_bar.tril()
    S = Bbar_t = None
    if Xbar_t is not None:
        X_bar = Xbar_t.mT
        B_bar = tri_solve(L, tri_solve(L, X_bar) if full else X_bar, trans=True)
        S = matmul(B_bar, Xt)
        Bbar_t = B_bar.mT
        if not full:
            G = G - S.tril()
    P = matmul(L.mT, G).tril()
    P = P - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
    Z = tri_solve(L, P.mT, trans=True).mT  # P L^-1
    Y = tri_solve(L, Z, trans=True)
    A_bar = 0.5 * (Y + Y.mT)
    if full and S is not None:
        A_bar = A_bar - 0.5 * (S + S.mT)
    return A_bar, Bbar_t


class CholSolveSmall(torch.autograd.Function):
    """(L, X) = (chol(A), L^-1 B), or with ``full`` (chol(A), A^-1 B), for
    SPD A [..., m, m] (its lower triangle read) and B [..., m, k] of the same
    leading dimensions, with the closed-form backward of
    :func:`_chol_small_bwd_plain`. Only L and X are saved. On a card both
    directions are one kernel launch each (csrc/chol_small.cu); on the CPU
    the forward is :func:`chol_factor` and the triangular solves, and the
    backward the kernel's formulas in torch, the kernels' oracle.

    On a card X is the transpose of a contiguous [..., k, m] (so X^T, the
    FITC model's V and W, is contiguous). A non-SPD A gives what
    :func:`chol_factor` gives: NaN on and below the diagonal, 0 above, X and
    the gradient NaN. A cotangent that does not reach the loss is not
    materialized (None)."""

    @staticmethod
    def forward(ctx, A, B, full: bool = False):
        ctx.set_materialize_grads(False)
        ctx.full = full
        if A.device.type == "cuda":
            L, Xt = _chol_small_fwd_cuda(A, B.mT, full)
            X = Xt.mT
        else:
            L = chol_factor(A)
            X = chol_solve_from_factor(L, B) if full else tri_solve(L, B)
        ctx.save_for_backward(L, X)
        return L, X

    @staticmethod
    def backward(ctx, L_bar, X_bar):
        L, X = ctx.saved_tensors
        Xbar_t = None if X_bar is None else X_bar.mT
        bwd = _chol_small_bwd_cuda if L.device.type == "cuda" else _chol_small_bwd_plain
        A_bar, Bbar_t = bwd(L, X.mT, L_bar, Xbar_t, ctx.full)
        return A_bar, None if Bbar_t is None else Bbar_t.mT, None


def chol_small_path(A, B) -> str:
    """"fused" for a CUDA float32 or float64 A with m <= CHOL_SMALL_MAX_M and
    B of its dtype and leading dimensions, else "library"."""
    fused = (A.device.type == "cuda" and A.dtype in _build.DTYPES and B.dtype == A.dtype
             and A.shape[-1] <= CHOL_SMALL_MAX_M and A.shape[:-2] == B.shape[:-2])
    return "fused" if fused else "library"


def chol_solve_small(A, B, *, full: bool = False):
    """(L, X) for SPD A [..., m, m] and B [..., m, k]: L = chol(A) and
    X = L^-1 B, or with ``full`` X = A^-1 B.

    The fused kernels (:class:`CholSolveSmall`) take the calls that
    :func:`chol_small_path` names; every other call takes the library chain,
    :func:`chol_factor` and :func:`tri_solve` (:func:`chol_solve_from_factor`),
    which also broadcasts leading dimensions. ``CHOL_SMALL`` counts the calls
    by path; each call is a ``chol.small`` span (path, m, k, batch: A's
    leading dimensions' product or None, full)."""
    m, k = A.shape[-1], B.shape[-1]
    path = chol_small_path(A, B)
    CHOL_SMALL[path] += 1
    lead = A.shape[:-2]
    with profiling.span("chol.small", A.device, path=path, m=m, k=k,
                        batch=math.prod(lead) if lead else None, full=full):
        if path == "fused":
            return CholSolveSmall.apply(A, B, full)
        L = chol_factor(A)
        return L, chol_solve_from_factor(L, B) if full else tri_solve(L, B)


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
