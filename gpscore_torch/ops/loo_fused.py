"""Fused ARD-Gram + solve cores for the exact GP at large n (port of
`gpscore/ops/loo_fused.py`): LOO, k-fold and NLML.

The composed objective ``params -> K -> solve core -> score`` holds K, K^-1,
the cotangent K_bar and a matmul temporary across a value-and-grad: four n^2
buffers. Each core here is one ``torch.autograd.Function`` whose saved set is
chosen by hand:

- forward: K_hat is built, factored and inverted in one n x n buffer
  (:mod:`gpscore_torch.ops.potri_inplace`); only K^-1, a = K^-1 y and O(n)
  tensors are saved.
- backward: the parameter gradient is the contraction
      theta_bar = sum_ij K_hat_bar_ij dK_hat_ij / dtheta,
      K_hat_bar = -(K^-1 a_bar) a^T - K^-1 S(cot) K^-1
  with S = diag(d_bar) for LOO and blockdiag(A_bar) for k-fold, and
  K_hat_bar = v_bar (K^-1 - a a^T) / 2 for NLML. dK_hat/dtheta is
  symmetric, so only the symmetric part of K_hat_bar counts: S is taken
  symmetric and the rank-1 term as -(w a^T + a w^T) / 2. The backward
  streams over row blocks [r0, r1) of K^-1: each block forms the lower
  block-triangle of its rows, the columns [0, r1) (one [b, n] x [n, r1]
  GEMM), weights the columns left of its diagonal block twice and hands the
  [b, r1] rows to the Gram backward kernels (``gram_bwd_rows``,
  ``gram_bwd_cols``) as the cotangent of K(x_b, x[:r1]), so neither K nor
  K_hat_bar exists at n x n. Over all blocks the GEMM is ~n^3 (1 + b/n),
  against 2 n^3 for full rows. Peak: n^2 plus a few [b, n] blocks.

With xs = x / l the scaled inputs and, per block, (d_xs_b, rowsum_b) and
d_xps_b the kernels' outputs (as in :class:`~gpscore_torch.ops.gram_cuda.ArdGram`):

    log_signal_bar = sum_b sum rowsum_b                    (= sum K_hat_bar o K)
    log_length_bar = -sum_b (sum_i d_xs_b * xs_b + sum_j d_xps_b * xs[:r1])
    log_noise_bar  = exp(log_noise_sq) * trace(K_hat_bar)

The gradients go to the three log-parameters and to y; x gets none, as in
the JAX package.

Precision (:mod:`gpscore_torch.utils.precision`): the forward runs at
``storage_dtype()``, so in the "bf16"/"f16" modes K^-1 is a 2-byte n x n
buffer (`loo_fused.py:127-141`). Everything of size O(n) stays fp32: a =
matmul_acc32(K^-1, y rounded to the storage dtype), the diagonal upcast. The
backward's [b, r1] products read K^-1 through ``matmul_acc32`` with the
left operand rounded to the storage dtype (`:380-384`), so the cotangent
rows that reach the Gram backward kernels are fp32 in every mode
(`:169-172`). In "high"/"fast" the products are the modes' TF32 passes on the
fp32 K^-1, split one [n, 1024] column panel of K^-1 at a time; in "highest"
their inner dimension is summed in chunks (``matmul_split_k``).
"""

from __future__ import annotations

import math

import torch

from gpscore_torch.ops import gram_cuda, linalg, potri_inplace
from gpscore_torch.utils import profiling
from gpscore_torch.utils.precision import (TWO_BYTE, acc_dtype, matmul_acc32, matmul_split_k,
                                           storage_dtype, upcast)

# ~4 fp32 [n, block] temporaries are live at the backward's peak (the K^-1
# row block scaled by the cotangent, its product with K^-1, and the kernels'
# inputs), next to the n^2 inverse.
_STREAM_TEMP_ROWS = 4

# Row blocks the streamed passes have handed to the Gram backward, by path:
# "lower" the single-device cores' columns [0, r1), "full" the sharded
# backward's rows over a rank's columns (:func:`_stream_param_grads`).
STREAM_BLOCKS = {"lower": 0, "full": 0}

# The JAX package also keeps a second, non-in-place forward below its
# _INPLACE_MIN_N = 8192 (`loo_fused.py:68`), chosen by a TPU measurement. The
# port has the in-place forward alone, at every n.


def _device_budget(device) -> float:
    """Bytes this process can still hold on ``device``: the card's free
    memory plus what PyTorch's allocator caches unused. Unbounded on the CPU."""
    if device is None or torch.device(device).type != "cuda":
        return math.inf
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def auto_block(n: int, budget_bytes=None, device=None, storage_bytes=None) -> int:
    """Panel and stream width for the fused cores at size ``n``
    (`loo_fused.py:86-106`): the widest of 2048, 1024 and 512 that divides n
    and whose ~4 fp32 [n, block] temporaries fit in the budget next to the
    n^2 inverse of ``storage_bytes`` an entry (None: the mode's storage
    dtype's); the narrowest divisor when none fits; 2048 (a ragged last
    panel) when none divides. ``budget_bytes`` defaults to what ``device``
    has left (:func:`_device_budget`)."""
    cands = [c for c in (2048, 1024, 512) if n % c == 0]
    if not cands:
        return 2048
    if budget_bytes is None:
        budget_bytes = _device_budget(device)
    if storage_bytes is None:
        storage_bytes = storage_dtype().itemsize
    free = budget_bytes - float(storage_bytes) * n * n
    for c in cands:
        if _STREAM_TEMP_ROWS * 4.0 * n * c <= free:
            return c
    return cands[-1]


def _resolve_block(x, block) -> int:
    return auto_block(x.shape[0], device=x.device) if block is None else int(block)


def _stream_param_grads(rows_of, w, a, xs, sig, block: int, xs_cols=None, col0: int = 0):
    """(log_signal_bar, log_length_bar [d], trace(K_hat_bar)) of one streamed
    pass over row blocks [r0, r1). ``rows_of(r0, r1)`` gives the block's rows
    of a symmetric term of K_hat_bar (a fresh tensor, updated in place); the
    pass adds the rank-1 term -w a^T unless ``w`` is None, and hands the rows
    to the Gram backward kernels with the block's scaled inputs.

    On one device (``xs_cols`` None) ``rows_of`` gives the columns [0, r1)
    alone: the lower block-triangle. dK_hat/dtheta is symmetric, so the
    contraction reads only the symmetric part of K_hat_bar; the pass enters
    the rank-1 term as -(w a^T + a w^T) / 2 and weights the columns left of
    the diagonal block twice. Otherwise the columns are those of the scaled
    inputs ``xs_cols`` from column ``col0`` on, ``a`` then being a's entries
    there: a rank's full rows in the sharded backward, whose partial sums the
    caller all-reduces. A backward of several passes (one per fold) adds
    their sums; ``STREAM_BLOCKS`` counts the blocks by path."""
    n = xs.shape[0]
    lower = xs_cols is None
    sig_bar = a.new_zeros(())
    len_bar = xs.new_zeros((xs.shape[1],))
    trace = a.new_zeros(())
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        g = rows_of(r0, r1)
        if lower:
            cols, c0 = xs[:r1], 0
            if w is not None:
                g.addr_(w[r0:r1], a[:r1], alpha=-0.5).addr_(a[r0:r1], w[:r1], alpha=-0.5)
            g[:, :r0].mul_(2.0)
        else:
            cols, c0 = xs_cols, col0
            if w is not None:
                g.addr_(w[r0:r1], a, alpha=-1.0)
        if c0 <= r0 < c0 + cols.shape[0]:  # the diagonal block is among the columns
            trace = trace + torch.sum(torch.diagonal(g[:, r0 - c0:r1 - c0]))
        STREAM_BLOCKS["lower" if lower else "full"] += 1
        xs_b = xs[r0:r1]
        d_xs, d_xps, row = gram_cuda.gram_bwd(xs_b, cols, sig, g.contiguous())
        del g  # before the next block's rows exist
        sig_bar = sig_bar + torch.sum(row)
        len_bar = len_bar - torch.sum(d_xs * xs_b, dim=0) - torch.sum(d_xps * cols, dim=0)
    return sig_bar, len_bar, trace


def _w(Kinv, a_bar):
    """K^-1 a_bar [n] (fp32), a_bar rounded to K^-1's storage dtype."""
    return matmul_acc32(Kinv, a_bar.reshape(-1, 1).to(Kinv.dtype))[:, 0]


def _length_grad(len_bar, log_length):
    """The length gradient in the shape of ``log_length`` (one length shared
    by every dimension takes the sum)."""
    if log_length.numel() != len_bar.numel():
        len_bar = len_bar.sum()
    return len_bar.reshape(log_length.shape)


def _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block, half_logdet=False):
    """The shared forward: K^-1 (and the half log-det), a = K^-1 y. Returns
    (the tensors every backward reads, to be saved first: K^-1, a, the O(nd)
    scaled inputs, the signal variance and two log-parameters; the half
    log-det or None)."""
    out = potri_inplace.ard_gram_inverse_inplace(log_signal_sq, log_length, log_noise_sq, x,
                                                 block, return_half_logdet=half_logdet,
                                                 storage=storage_dtype())
    Kinv = out[0] if half_logdet else out
    a = matmul_acc32(Kinv, y.reshape(-1, 1).to(Kinv.dtype))[:, 0]
    xs = gram_cuda.scale_inputs(x, log_length)
    ctx.block = block
    saved = (Kinv, a, xs, torch.exp(log_signal_sq), log_noise_sq, log_length)
    return saved, (out[1] if half_logdet else None)


def _param_grads(sums, sig, log_length, log_noise_sq):
    """The three log-parameter gradients from the sums of
    :func:`_stream_param_grads`."""
    s_bar, len_bar, trace = sums
    return (s_bar.reshape(sig.shape), _length_grad(len_bar, log_length),
            torch.exp(log_noise_sq) * trace)


def lower_cols(Kinv, r1: int, rows=slice(None)):
    """K^-1[rows, :r1], the right operand of a row block's product, read as
    K^-1[:r1, rows]^T (K^-1 is symmetric): r1 rows of K^-1, each contiguous
    over ``rows``; ~1% faster than the strided view on an NVIDIA H100."""
    return Kinv[:r1, rows].T


def _backward(ctx, w, rows_of):
    """One streamed pass and the parameter gradients of it: ``rows_of(r0,
    r1)`` gives the rows [r0, r1) of the symmetric term over columns [0, r1)."""
    Kinv, a, xs, sig, log_noise_sq, log_length = ctx.saved_tensors[:6]
    sums = _stream_param_grads(rows_of, w, a, xs, sig, ctx.block)
    return _param_grads(sums, sig, log_length, log_noise_sq)


class ArdLooSolveDiag(torch.autograd.Function):
    """(a, d) = (K_hat^-1 y, diag K_hat^-1) for K_hat = K_ard(x) + noise I
    (`loo_fused.py:242-294`)."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block):
        with profiling.span("core.forward", x.device, core="loo", n=x.shape[0], block=block):
            saved, _ = _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block)
            ctx.save_for_backward(*saved)
            Kinv, a = saved[:2]
            return a, upcast(torch.diagonal(Kinv)).clone()

    @staticmethod
    def backward(ctx, a_bar, d_bar):
        Kinv = ctx.saved_tensors[0]

        def rows_of(r0, r1):  # rows of -K^-1 diag(d_bar) K^-1, columns [0, r1)
            # The left factor in K^-1's dtype: a 2-byte one rounded once, no fp32 block.
            Kinv_b = Kinv[r0:r1]
            M = torch.mul(Kinv_b, d_bar[None, :], out=torch.empty_like(Kinv_b))
            return matmul_split_k(M, lower_cols(Kinv, r1)).neg_()

        with profiling.span("core.backward", Kinv.device, core="loo", passes=1, cols="lower"):
            w = _w(Kinv, a_bar)
            s_bar, l_bar, n_bar = _backward(ctx, w, rows_of)
        return s_bar, l_bar, n_bar, None, w, None


class ArdKfoldSolveBlocks(torch.autograd.Function):
    """(a, A) = (K_hat^-1 y, the fold_k diagonal blocks [K_hat^-1]_bb stacked
    [fold_k, nb, nb]) (`loo_fused.py:302-394`). Raises ``ValueError`` unless
    fold_k divides n."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, fold_k, block):
        n = x.shape[0]
        if n % fold_k:
            raise ValueError(f"n={n} not divisible by fold_k={fold_k}")
        with profiling.span("core.forward", x.device, core="kfold", n=x.shape[0], block=block):
            saved, _ = _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block)
            ctx.save_for_backward(*saved)
            ctx.fold_k = fold_k
            Kinv, a = saved[:2]
            return a, upcast(linalg._fold_blocks(Kinv, fold_k)).contiguous()

    @staticmethod
    def backward(ctx, a_bar, A_bar):
        Kinv = ctx.saved_tensors[0]
        n, k = Kinv.shape[0], ctx.fold_k
        nb, st = n // k, Kinv.dtype

        def rows_of(r0, r1):  # rows of -K^-1 blockdiag(sym A_bar) K^-1, columns [0, r1)
            # Fold by fold, each fold's symmetric part one nb^2 transient; a
            # 2-byte one rounded once to the storage dtype (`loo_fused.py:359-384`).
            Kinv_b = Kinv[r0:r1]
            M = Kinv_b.new_empty(Kinv_b.shape, dtype=acc_dtype(st))
            for f in range(k):
                fs = slice(f * nb, (f + 1) * nb)
                S = (A_bar[f] + A_bar[f].mT).mul_(0.5)
                if st in TWO_BYTE:
                    M[:, fs] = matmul_acc32(Kinv_b[:, fs], S.to(st))
                else:
                    M[:, fs] = torch.matmul(Kinv_b[:, fs], S)
                del S
            return matmul_split_k(M.to(st), lower_cols(Kinv, r1)).neg_()

        with profiling.span("core.backward", Kinv.device, core="kfold", passes=1, cols="lower"):
            w = _w(Kinv, a_bar)
            s_bar, l_bar, n_bar = _backward(ctx, w, rows_of)
        return s_bar, l_bar, n_bar, None, w, None, None


class ArdNlml(torch.autograd.Function):
    """0.5 n log 2pi + 0.5 log det K_hat + 0.5 y^T K_hat^-1 y with its
    streamed backward (`loo_fused.py:402-505`): K_hat_bar = v_bar (K^-1 -
    a a^T) / 2 reads off K^-1's rows, so the backward has no n^3 GEMM."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block):
        with profiling.span("core.forward", x.device, core="nlml", n=x.shape[0], block=block):
            saved, hld = _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block,
                                  half_logdet=True)
            ctx.save_for_backward(*saved)
            return (0.5 * x.shape[0] * math.log(2.0 * math.pi) + hld
                    + 0.5 * torch.dot(y, saved[1]))

    @staticmethod
    def backward(ctx, v_bar):
        half = 0.5 * v_bar
        Kinv, a = ctx.saved_tensors[:2]

        def rows_of(r0, r1):  # rows of v_bar K^-1 / 2, columns [0, r1)
            Kinv_b = Kinv[r0:r1, :r1]
            if Kinv_b.dtype in TWO_BYTE:
                return Kinv_b.float().mul_(half)
            return half * Kinv_b

        with profiling.span("core.backward", a.device, core="nlml", passes=1, cols="lower"):
            s_bar, l_bar, n_bar = _backward(ctx, half * a, rows_of)
        return s_bar, l_bar, n_bar, None, v_bar * a, None


def ard_loo_solve_diag(log_signal_sq, log_length, log_noise_sq, x, y, block=None):
    """(K_hat^-1 y, diag K_hat^-1); ``block`` None takes :func:`auto_block`."""
    return ArdLooSolveDiag.apply(log_signal_sq, log_length, log_noise_sq, x, y,
                                 _resolve_block(x, block))


def ard_kfold_solve_blocks(log_signal_sq, log_length, log_noise_sq, x, y, fold_k: int,
                           block=None):
    """(K_hat^-1 y, [K_hat^-1]_bb stacked); ``block`` as in :func:`ard_loo_solve_diag`."""
    return ArdKfoldSolveBlocks.apply(log_signal_sq, log_length, log_noise_sq, x, y, fold_k,
                                     _resolve_block(x, block))


def ard_nlml(log_signal_sq, log_length, log_noise_sq, x, y, block=None):
    """The NLML of the exact GP. Where no gradient is asked for (grad mode off
    or no input requires one), the value alone: the in-place Cholesky and one
    triangular solve, no inverse."""
    block = _resolve_block(x, block)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (log_signal_sq, log_length, log_noise_sq, y)):
        return ArdNlml.apply(log_signal_sq, log_length, log_noise_sq, x, y, block)
    st = storage_dtype()
    L, hld = potri_inplace.ard_gram_chol_inplace(log_signal_sq, log_length, log_noise_sq, x,
                                                 block, storage=st)
    if st not in TWO_BYTE:
        z = linalg.tri_solve(L, y.reshape(-1, 1))
    else:
        z = potri_inplace.tri_solve_stored(L, upcast(y.reshape(-1, 1).to(st)), block)
    return 0.5 * x.shape[0] * math.log(2.0 * math.pi) + hld + 0.5 * torch.sum(z * z)
