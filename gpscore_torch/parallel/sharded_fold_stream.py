"""Mesh-sharded fold-streamed k-fold objectives: no fold stack on any rank
(port of `gpscore/parallel/sharded_fold_stream.py`).

The single-device fold-streamed cores (:mod:`gpscore_torch.ops.fold_stream`)
on the row-sharded K_hat^-1 of the in-place sharded pipeline
(:func:`~gpscore_torch.parallel.sharded_potri.ard_gram_inverse_inplace_sharded`).
One fold's [nb, nb] block (nb = n / fold_k) is assembled from the row shard
at a time (:func:`_gather_fold_strip`: a **broadcast** from its owner when a
rank holds whole folds, one broadcast per rank of the fold in turn when a
fold spans ranks), factored, scored and adjointed the same on every rank (k
O(nb^3) of small dense work next to the n^3 factorization), and its
sandwich term of the parameter cotangent is streamed over global row blocks
before the next fold's block exists. Per rank:

    n^2/p in the storage dtype (K_hat^-1's rows)
    + 1-2 [nb, nb] fold transients (the same on every rank)
    + [b, n/p] stream temporaries.

Backward, per fold f with S_f = -A_bar_f (the fold's cotangent, rounded to
the storage dtype): this rank's columns R_q of the fold's term for row block
B are G_f^T S_f K^-1[f, R_q], with G_f = K^-1[f, B] gathered ([nb, b]) and
K^-1[f, R_q] = (K^-1[R_q, f])^T a local slice (K^-1 is symmetric): each
rank computes its own columns, no reduce-scatter. Two contraction orders,
by mesh shape (`sharded_fold_stream.py:34-43`):

- p <= fold_k (a rank's rows >= nb): (G_f^T S_f) [b, nb] per row block,
  then against the local slice; no [nb, n/p] temporary.
- p > fold_k: N_f = S_f K^-1[f, R_q] [nb, n/p] once per fold (n^2/(k p),
  small at such p), then G_f^T N_f per row block.

a_bar, the cotangent of a = K^-1 y, is complete only after the last fold
adds its u = A_f^-1 e_bar_f, so the rank-1 term -w a^T (w = K^-1 a_bar)
rides the last fold's pass, as in the single-device core; JAX's separate
rank-1 pass (`_rank1_accs_sharded`) is not needed. Every rank issues every
broadcast of every fold and row block in the same order.

The energy score takes its normals as ``eps`` [k, nb, 2 num_sim] (the JAX
package's per-fold layout) or draws them in that shape from an explicit
``generator`` (seeded alike on every rank); never from the global one. They
are saved for the backward (O(n num_sim)), where JAX regenerates them from
counter keys.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gpscore_torch.ops import fold_stream, gram_cuda
from gpscore_torch.ops.loo_fused import _param_grads, _stream_param_grads, _w
from gpscore_torch.parallel.mesh import Mesh, broadcast, gather_rows
from gpscore_torch.parallel.sharded_kfold import KFOLD_RULES
from gpscore_torch.parallel.sharded_loo import _fused_step
from gpscore_torch.parallel.sharded_potri import (_check_divisible, _reduce_grads,
                                                  ard_gram_inverse_inplace_sharded)
from gpscore_torch.scoring import rules
from gpscore_torch.utils.precision import TWO_BYTE, matmul_acc32, storage_dtype, upcast


def _check_fold_tiling(n: int, p: int, fold_k: int) -> int:
    """nb = n / fold_k, after checking that folds and a rank's rows tile each other."""
    if n % fold_k:
        raise ValueError(f"n={n} not divisible by fold_k={fold_k}")
    nb, rows_per = n // fold_k, n // p
    if not (nb % rows_per == 0 or rows_per % nb == 0):
        raise ValueError(f"fold size {nb} and device rows {rows_per} must tile each other")
    return nb


def _gather_fold_strip(Kinv_local, f: int, c0: int, w: int, nb: int, mesh: Mesh, axis: str):
    """K^-1[fold f's rows, c0:c0 + w] [nb, w] in K^-1's dtype, the same on
    every rank: a broadcast from the rank that holds the fold, or, where
    the fold spans ranks, one broadcast of its [n/p, w] rows from each of
    them in turn."""
    rows_per = Kinv_local.shape[0]
    me = mesh.index(axis)
    if nb <= rows_per:
        owner, off = divmod(f * nb, rows_per)
        buf = (Kinv_local[off:off + nb, c0:c0 + w].contiguous() if me == owner
               else Kinv_local.new_empty((nb, w)))
        return broadcast(buf, owner, mesh, axis)
    out = Kinv_local.new_empty((nb, w))
    first = f * nb // rows_per
    for i in range(nb // rows_per):
        part = out[i * rows_per:(i + 1) * rows_per]
        if me == first + i:
            part.copy_(Kinv_local[:, c0:c0 + w])
        broadcast(part, first + i, mesh, axis)
    return out


def _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, mesh, axis, fold_k, block):
    """K_hat^-1's rows, a = K^-1 y (gathered) and nb, after the shape
    checks; stores what the backward reads on ``ctx`` except the fold
    outputs."""
    n = x.shape[0]
    _check_divisible(n, mesh.size(axis), block)
    nb = _check_fold_tiling(n, mesh.size(axis), fold_k)
    Kinv, _ = ard_gram_inverse_inplace_sharded(log_signal_sq, log_length, log_noise_sq, x, mesh,
                                               axis, block, storage=storage_dtype())
    a = gather_rows(matmul_acc32(Kinv, y.reshape(-1, 1).to(Kinv.dtype))[:, 0], mesh, axis)
    ctx.mesh, ctx.axis, ctx.fold_k, ctx.block = mesh, axis, fold_k, block
    return Kinv, a, nb


def _fold_block(Kinv, f: int, nb: int, mesh: Mesh, axis: str):
    """Fold f's diagonal block [K^-1]_ff in fp32, the same on every rank."""
    return upcast(_gather_fold_strip(Kinv, f, f * nb, nb, nb, mesh, axis))


def _stream_folds(ctx, a_bar, fold_cot):
    """The shared backward: (log_signal_bar, log_length_bar, log_noise_bar,
    y_bar), replicated. ``fold_cot(f, A_f)`` returns fold f's (-A_bar_f
    [nb, nb], u [nb]); ``a_bar`` [n], the cotangent of the output a, is
    updated in place."""
    Kinv, a, x, log_signal_sq, log_length, log_noise_sq = ctx.saved_tensors[:6]
    mesh, axis, k, b = ctx.mesh, ctx.axis, ctx.fold_k, ctx.block
    rows_per, st = Kinv.shape[0], Kinv.dtype
    n = a.shape[0]
    nb = n // k
    row0 = mesh.index(axis) * rows_per
    xs = gram_cuda.scale_inputs(x, log_length)
    xs_loc = xs[row0:row0 + rows_per]
    sig = torch.exp(log_signal_sq)
    parts, w = None, None
    for f in range(k):
        fs = slice(f * nb, (f + 1) * nb)
        S, u = fold_cot(f, _fold_block(Kinv, f, nb, mesh, axis))
        S = S.to(st)  # rounded once before the sandwich
        a_bar[fs] += u
        if f == k - 1:  # a_bar is complete: the rank-1 term rides this pass
            w = gather_rows(_w(Kinv, a_bar), mesh, axis)
        KfT = Kinv[:, fs].T  # K^-1[f, R_q]
        N = matmul_acc32(S, KfT).to(st) if rows_per < nb else None

        def cols_of(s, _):  # this rank's columns of -K^-1[B, f] A_bar_f K^-1[f, :]
            G = _gather_fold_strip(Kinv, f, s, b, nb, mesh, axis)  # K^-1[f, B]
            if N is not None:
                return matmul_acc32(G.T, N)
            return matmul_acc32(matmul_acc32(G.T, S).to(st), KfT)

        part = _stream_param_grads(cols_of, w if f == k - 1 else None, a[row0:row0 + rows_per],
                                   xs, sig, b, xs_loc, row0)
        parts = part if parts is None else tuple(p + q for p, q in zip(parts, part))
        del S, N, cols_of  # one fold cotangent live at a time
    sums = _reduce_grads(parts, mesh, axis)
    return (*_param_grads(sums, sig, log_length, log_noise_sq), w)


class _FoldStatsSharded(torch.autograd.Function):
    """(e [k, nb], hld [k], inv_diag [k, nb], a [n]), replicated
    (:func:`make_sharded_streamed_fold_stats`)."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, mesh, axis, fold_k,
                want_inv_diag, block):
        Kinv, a, nb = _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, mesh, axis,
                               fold_k, block)
        e = a.new_empty((fold_k, nb))
        hld = a.new_empty((fold_k,))
        inv_diag = a.new_zeros((fold_k, nb))
        for f in range(fold_k):
            s = slice(f * nb, (f + 1) * nb)
            e[f], hld[f], d = fold_stream._fold_stats(_fold_block(Kinv, f, nb, mesh, axis), a[s],
                                                      want_inv_diag)
            if want_inv_diag:
                inv_diag[f] = d
        ctx.want_inv_diag = want_inv_diag
        ctx.save_for_backward(Kinv, a, x, log_signal_sq, log_length, log_noise_sq, e)
        return e, hld, inv_diag, a

    @staticmethod
    def backward(ctx, e_bar, hld_bar, d_bar, a_bar):
        e = ctx.saved_tensors[6]

        def fold_cot(f, A):
            return fold_stream._stats_fold_cot(A, e[f], e_bar[f], hld_bar[f],
                                               d_bar[f] if ctx.want_inv_diag else None,
                                               ctx.block)

        s_bar, l_bar, n_bar, w = _stream_folds(ctx, a_bar.clone(), fold_cot)
        return s_bar, l_bar, n_bar, None, w, None, None, None, None, None


class _FoldEsSharded(torch.autograd.Function):
    """The per-fold energy scores [k], replicated
    (:func:`make_sharded_streamed_fold_es`)."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, eps, mesh, axis, fold_k,
                num_sim, beta, block):
        Kinv, a, nb = _forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, mesh, axis,
                               fold_k, block)
        if Kinv.dtype in TWO_BYTE:
            eps = eps.to(Kinv.dtype).to(eps.dtype)  # the normals in the storage dtype
        e = a.new_empty((fold_k, nb))
        scores = a.new_empty((fold_k,))
        for f in range(fold_k):
            s = slice(f * nb, (f + 1) * nb)
            scores[f], e[f] = fold_stream._fold_es(_fold_block(Kinv, f, nb, mesh, axis), a[s],
                                                   eps[f], num_sim, beta)
        ctx.num_sim, ctx.beta = num_sim, beta
        ctx.save_for_backward(Kinv, a, x, log_signal_sq, log_length, log_noise_sq, e, eps)
        return scores

    @staticmethod
    def backward(ctx, s_bar):
        a, e, eps = ctx.saved_tensors[1], ctx.saved_tensors[6], ctx.saved_tensors[7]

        def fold_cot(f, A):
            return fold_stream._es_fold_cot(A, e[f], eps[f], s_bar[f], ctx.num_sim, ctx.beta)

        s_bar_, l_bar, n_bar, w = _stream_folds(ctx, torch.zeros_like(a), fold_cot)
        return s_bar_, l_bar, n_bar, None, w, None, None, None, None, None, None, None


def make_sharded_streamed_fold_stats(mesh: Mesh, fold_k: int, want_inv_diag: bool = True,
                                     axis: str = "data", block: int = 256):
    """The sharded twin of
    :func:`gpscore_torch.ops.fold_stream.ard_fold_stats_stream`:
    ``f(log_signal_sq, log_length, log_noise_sq, x, y) -> (e [k, nb], hld [k],
    inv_diag [k, nb], a [n])`` for the fold conditionals A_f = [K_hat^-1]_ff
    (reference `kin40k-FULL-compare.py:500-530`), x [n, d] and y [n]
    replicated, every output replicated; differentiable in the three
    log-parameters and y. Raises ``ValueError`` unless n divides by p *
    block and by fold_k, and a rank's rows and the folds tile each other."""

    def f(log_signal_sq, log_length, log_noise_sq, x, y):
        return _FoldStatsSharded.apply(log_signal_sq, log_length, log_noise_sq, x, y.reshape(-1),
                                       mesh, axis, fold_k, want_inv_diag, block)

    return f


def make_sharded_streamed_fold_es(mesh: Mesh, fold_k: int, num_sim: int = 300,
                                  es_beta: float = 1.0, axis: str = "data", block: int = 256):
    """The sharded twin of
    :func:`gpscore_torch.ops.fold_stream.ard_fold_es_stream`:
    ``f(log_signal_sq, log_length, log_noise_sq, x, y, generator=None,
    eps=None) -> scores [k]``, the per-fold Monte-Carlo energy scores
    (reference `kin40k-FULL-compare.py:616-657`), replicated. ``eps`` [k, nb,
    2 num_sim] fixes the normals; else they are drawn in that shape from
    ``generator`` on x's device, which every rank must seed alike; with
    neither, ``ValueError``. Shape checks as
    :func:`make_sharded_streamed_fold_stats`."""

    def f(log_signal_sq, log_length, log_noise_sq, x, y, generator=None, eps=None):
        nb = x.shape[0] // fold_k
        if eps is None:
            if generator is None:
                raise ValueError("the es core needs eps or a generator")
            eps = torch.randn((fold_k, nb, 2 * num_sim), generator=generator, dtype=x.dtype,
                              device=x.device)
        return _FoldEsSharded.apply(log_signal_sq, log_length, log_noise_sq, x, y.reshape(-1),
                                    eps, mesh, axis, fold_k, num_sim, es_beta, block)

    return f


def make_sharded_streamed_kfold_fit_step(mesh: Mesh, rule: str = "dss", fold_k: int = 4,
                                         lr: float = 0.001, axis: str = "data",
                                         block: int = 256, num_sim: int = 300,
                                         es_beta: float = 1.0):
    """The fold-streamed sharded k-fold gradient step of ``rule`` (dss, kc
    or es): ``step(params, x, y, generator=None, eps=None) -> (loss, updated
    params)``, x this rank's rows, y [n] and params replicated; es needs
    ``eps`` or ``generator`` (:func:`make_sharded_streamed_fold_es`). The
    objective's math is the single-device fold-streamed one's
    (``fit.objectives``); no [fold_k, nb, nb] stack on any rank. Built once,
    run eagerly each call."""
    if rule not in KFOLD_RULES:
        raise ValueError(f"rule must be one of {KFOLD_RULES}, got {rule!r}")
    if rule == "es":
        es_fn = make_sharded_streamed_fold_es(mesh, fold_k, num_sim, es_beta, axis, block)
    else:
        stats_fn = make_sharded_streamed_fold_stats(mesh, fold_k, rule == "kc", axis, block)

    def make(generator, eps):
        def loss_of(p, x, y):
            if rule == "es":
                return torch.sum(es_fn(p.log_signal_sq, p.log_length, p.log_noise_sq, x, y,
                                       generator=generator, eps=eps))
            e, hld, inv_diag, a = stats_fn(p.log_signal_sq, p.log_length, p.log_noise_sq, x, y)
            y_b = y.reshape(fold_k, -1)
            if rule == "dss":
                # DSS_f = nb/2 log 2pi - hld_f + 1/2 e_f^T a_f (A_f e_f = a_f).
                return (0.5 * y.shape[0] * math.log(2.0 * math.pi) - torch.sum(hld)
                        + 0.5 * torch.sum(e * a.reshape(fold_k, -1)))
            return rules.crps_kfold(y_b - e, inv_diag, y_b)

        return _fused_step(loss_of, mesh, axis, lr)

    def step(params, x, y, generator: Optional[torch.Generator] = None, eps=None):
        if rule == "es" and generator is None and eps is None:
            raise ValueError("rule='es' is stochastic: pass a generator or eps")
        return make(generator, eps)(params, x, y)

    return step
