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
  K_hat_bar = v_bar (K^-1 - a a^T) / 2 for NLML. It streams over row blocks
  of K^-1: each block forms its rows of K_hat_bar (one [b, n] GEMM) and hands
  them to the Gram backward kernels (``gram_bwd_rows``, ``gram_bwd_cols``)
  as the cotangent of K(x_b, x), so neither K nor K_hat_bar exists at n x n.
  Peak: n^2 plus a few [b, n] blocks.

With xs = x / l the scaled inputs and, per block, (d_xs_b, rowsum_b) and
d_xps_b the kernels' outputs (as in :class:`~gpscore_torch.ops.gram_cuda.ArdGram`):

    log_signal_bar = sum_b sum rowsum_b                    (= sum K_hat_bar o K)
    log_length_bar = -sum_b (sum_i d_xs_b * xs_b + sum_j d_xps_b * xs)
    log_noise_bar  = exp(log_noise_sq) * trace(K_hat_bar)

The gradients go to the three log-parameters and to y; x gets none, as in
the JAX package.
"""

from __future__ import annotations

import math

import torch

from gpscore_torch.ops import gram_cuda, linalg, potri_inplace
from gpscore_torch.utils.precision import matmul

# ~4 fp32 [n, block] temporaries are live at the backward's peak (the K^-1
# row block scaled by the cotangent, its product with K^-1, and the kernels'
# inputs), next to the n^2 inverse.
_STREAM_TEMP_ROWS = 4

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


def auto_block(n: int, budget_bytes=None, device=None) -> int:
    """Panel and stream width for the fused cores at size ``n``
    (`loo_fused.py:86-106`): the widest of 2048, 1024 and 512 that divides n
    and whose ~4 fp32 [n, block] temporaries fit in the budget next to the
    n^2 fp32 inverse; the narrowest divisor when none fits; 2048 (a ragged
    last panel) when none divides. ``budget_bytes`` defaults to what
    ``device`` has left (:func:`_device_budget`)."""
    cands = [c for c in (2048, 1024, 512) if n % c == 0]
    if not cands:
        return 2048
    if budget_bytes is None:
        budget_bytes = _device_budget(device)
    free = budget_bytes - 4.0 * n * n
    for c in cands:
        if _STREAM_TEMP_ROWS * 4.0 * n * c <= free:
            return c
    return cands[-1]


def _resolve_block(x, block) -> int:
    return auto_block(x.shape[0], device=x.device) if block is None else int(block)


def _stream_param_grads(Kinv, a, w, extra_rows, xs, sig, block: int):
    """(log_signal_bar, log_length_bar [d], trace(K_hat_bar)) of one streamed
    pass: the rows of K_hat_bar for a row block are ``extra_rows(Kinv_b)``,
    minus ``w_b a^T`` unless ``w`` is None, and go through the Gram backward
    kernels with the block's scaled inputs. ``extra_rows`` returns a fresh
    [b, n] tensor, which is updated in place. A backward of several passes
    (one per fold) adds their sums."""
    n = a.shape[0]
    sig_bar = a.new_zeros(())
    len_bar = xs.new_zeros((xs.shape[1],))
    trace = a.new_zeros(())
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        g = extra_rows(Kinv[r0:r1])
        if w is not None:
            g.addr_(w[r0:r1], a, alpha=-1.0)
        trace = trace + torch.sum(torch.diagonal(g[:, r0:r1]))
        xs_b = xs[r0:r1]
        d_xs, d_xps, row = gram_cuda.gram_bwd(xs_b, xs, sig, g)
        sig_bar = sig_bar + torch.sum(row)
        len_bar = len_bar - torch.sum(d_xs * xs_b, dim=0) - torch.sum(d_xps * xs, dim=0)
    return sig_bar, len_bar, trace


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
                                                 block, return_half_logdet=half_logdet)
    Kinv = out[0] if half_logdet else out
    a = matmul(Kinv, y.reshape(-1, 1))[:, 0]
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


def _backward(ctx, w, extra_rows):
    """One streamed pass and the parameter gradients of it."""
    Kinv, a, xs, sig, log_noise_sq, log_length = ctx.saved_tensors[:6]
    sums = _stream_param_grads(Kinv, a, w, extra_rows, xs, sig, ctx.block)
    return _param_grads(sums, sig, log_length, log_noise_sq)


class ArdLooSolveDiag(torch.autograd.Function):
    """(a, d) = (K_hat^-1 y, diag K_hat^-1) for K_hat = K_ard(x) + noise I
    (`loo_fused.py:242-294`)."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block):
        saved, _ = _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block)
        ctx.save_for_backward(*saved)
        Kinv, a = saved[:2]
        return a, torch.diagonal(Kinv).clone()

    @staticmethod
    def backward(ctx, a_bar, d_bar):
        Kinv = ctx.saved_tensors[0]
        w = matmul(Kinv, a_bar.reshape(-1, 1))[:, 0]

        def extra_rows(Kinv_b):  # rows of -K^-1 diag(d_bar) K^-1
            return matmul(Kinv_b * d_bar[None, :], Kinv).neg_()

        s_bar, l_bar, n_bar = _backward(ctx, w, extra_rows)
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
        saved, _ = _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block)
        ctx.save_for_backward(*saved)
        ctx.fold_k = fold_k
        Kinv, a = saved[:2]
        return a, linalg._fold_blocks(Kinv, fold_k).contiguous()

    @staticmethod
    def backward(ctx, a_bar, A_bar):
        Kinv = ctx.saved_tensors[0]
        n, k = Kinv.shape[0], ctx.fold_k
        w = matmul(Kinv, a_bar.reshape(-1, 1))[:, 0]

        def extra_rows(Kinv_b):  # rows of -K^-1 blockdiag(A_bar) K^-1
            size = Kinv_b.shape[0]
            M = torch.einsum("sfi,fij->sfj", Kinv_b.reshape(size, k, n // k), A_bar)
            return matmul(M.reshape(size, n), Kinv).neg_()

        s_bar, l_bar, n_bar = _backward(ctx, w, extra_rows)
        return s_bar, l_bar, n_bar, None, w, None, None


class ArdNlml(torch.autograd.Function):
    """0.5 n log 2pi + 0.5 log det K_hat + 0.5 y^T K_hat^-1 y with its
    streamed backward (`loo_fused.py:402-505`): K_hat_bar = v_bar (K^-1 -
    a a^T) / 2 reads off K^-1's rows, so the backward has no n^3 GEMM."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block):
        saved, hld = _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block,
                              half_logdet=True)
        ctx.save_for_backward(*saved)
        return 0.5 * x.shape[0] * math.log(2.0 * math.pi) + hld + 0.5 * torch.dot(y, saved[1])

    @staticmethod
    def backward(ctx, v_bar):
        half = 0.5 * v_bar
        a = ctx.saved_tensors[1]

        def extra_rows(Kinv_b):
            return half * Kinv_b

        s_bar, l_bar, n_bar = _backward(ctx, half * a, extra_rows)
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
    L, hld = potri_inplace.ard_gram_chol_inplace(log_signal_sq, log_length, log_noise_sq, x,
                                                 block)
    z = linalg.tri_solve(L, y.reshape(-1, 1))
    return 0.5 * x.shape[0] * math.log(2.0 * math.pi) + hld + 0.5 * torch.sum(z * z)
