"""Fold-streamed fused k-fold cores for the exact GP at large n (port of
`gpscore/ops/fold_stream.py`): dss, kc and es with one fold's working set
live at a time.

The stacked composition (:func:`~gpscore_torch.ops.loo_fused.ard_kfold_solve_blocks`,
then factor the [k, nb, nb] stack and score it) holds the fold blocks, their
factors and the cotangent stack beside K^-1: two to three n^2/k tensors. The
two cores here fuse ``params -> K_hat^-1 -> fold conditionals -> fold
statistics`` into one ``torch.autograd.Function`` each and take the folds one
at a time off the n x n inverse, in a Python loop over fold numbers:

- forward: K^-1 from the in-place pipeline
  (:func:`~gpscore_torch.ops.potri_inplace.ard_gram_inverse_inplace`) and
  a = K^-1 y; per fold, the block A_f = [K^-1]_ff is factored
  (:func:`~gpscore_torch.ops.linalg.chol_factor`: cuSOLVER's potrf, NaN on
  failure, no host sync), its O(nb) statistics are emitted and the factor is
  dropped. Saved: K^-1, a, e, the scaled inputs and O(n) tensors (the es
  core also its normals). No [k, nb, nb] tensor is saved or returned.
- backward: per fold, refactor the block, assemble the fold's cotangent
  A_bar_f in closed form, and stream that fold's term of

      K_hat_bar = -w a^T - sum_f K^-1[:, f] A_bar_f K^-1[f, :],   w = K^-1 a_bar

  through :func:`~gpscore_torch.ops.loo_fused._stream_param_grads`: per row
  block two GEMMs ([b, nb] x [nb, nb], then [b, nb] x [nb, n], the second
  operand a view of the symmetric K^-1's rows) and the two Gram backward
  kernels. A_bar_f is freed before the next fold. a_bar is complete only
  after the last fold's u (below), so the rank-1 term -w a^T rides the last
  fold's pass. The Gram backward kernels run once per fold and row block:
  k times the LOO family's launches, the price of not holding k cotangents.

Per fold, with La the factor of A = A_f, e = A^-1 a_f and the cotangents
e_bar, hld_bar, d_bar of the outputs (`gpscore/ops/fold_core.py:332-427`):

    u   = A^-1 e_bar                        (the fold's share of a_bar)
    dss: A_bar = (hld_bar / 2) A^-1 - u e^T
    kc:  A_bar = ... - A^-1 diag(d_bar) A^-1
    es:  G = La^-1 Z_bar^T,  H = eps G^T,  T = La^-T Phi(H) La^-1,
         A_bar = -u e^T - T               (Phi: tril with a halved diagonal)

Z_bar and e_bar of the es core come from autograd of the O(nb S) score
arithmetic alone. The contraction reads only the symmetric part of A_bar
(dK_hat/dtheta is symmetric), so neither u e^T nor T is symmetrized, as the
JAX module does for its stored cotangent.

Blocks of nb^2 live beside K^-1, at most: the forward holds one (the factor;
two with ``want_inv_diag``), the dss backward two while it forms A^-1, the kc
and es backward two; every stream holds one. The JAX module forms the
explicit factor inverse and its own in-place fold stages, pads the blocks to
a panel grid and sums the rank-1 term through a separate Gram pass, for XLA
and its chip; here the folds go to cuSOLVER and cuBLAS trsm as they are.
"""

from __future__ import annotations

import torch

from gpscore_torch.ops import linalg, loo_fused
from gpscore_torch.utils.precision import matmul


def _check_folds(n: int, fold_k: int) -> int:
    if n % fold_k:
        raise ValueError(f"n={n} not divisible by fold_k={fold_k}")
    return n // fold_k


def _tri_inverse(La):
    """La^-1 for a lower-triangular La: one trsm, in place on an identity."""
    X = torch.eye(La.shape[0], dtype=La.dtype, device=La.device)
    return torch.linalg.solve_triangular(La, X, upper=False, out=X)


def _es_from_cols(zT, e_f, num_sim: int, beta: float):
    """One fold's energy score from its samples zT [nb, 2 S], columns z | z',
    and the fold's mean error e (r = m - y = -e) (`fold_core.py:452-462`)."""
    # Imported here: gpscore_torch.scoring imports gpscore_torch.ops.
    from gpscore_torch.scoring.rules import energy_score_core

    return energy_score_core(zT[:, :num_sim].T, zT[:, num_sim:].T, -e_f, num_sim, beta)


def _stream_folds(ctx, a_bar, fold_cot):
    """The shared backward: (log_signal_bar, log_length_bar, log_noise_bar,
    y_bar). ``fold_cot(f, A_f)`` returns fold f's (-A_bar_f [nb, nb], a fresh
    tensor; u [nb]); ``a_bar`` [n] is the cotangent of the
    output a, and is updated in place."""
    Kinv, a, xs, sig, log_noise_sq, log_length = ctx.saved_tensors[:6]
    k = ctx.fold_k
    nb = a.shape[0] // k
    sums, w = None, None
    for f in range(k):
        s = slice(f * nb, (f + 1) * nb)
        S, u = fold_cot(f, Kinv[s, s])
        a_bar[s] += u
        if f == k - 1:  # a_bar is complete: the rank-1 term rides this pass
            w = matmul(Kinv, a_bar.reshape(-1, 1))[:, 0]

        def extra_rows(Kinv_b):  # rows of -K^-1[:, f] A_bar_f K^-1[f, :]
            return matmul(matmul(Kinv_b[:, s], S), Kinv[s])

        part = loo_fused._stream_param_grads(Kinv, a, w, extra_rows, xs, sig, ctx.block)
        sums = part if sums is None else tuple(p + q for p, q in zip(sums, part))
        del S, extra_rows  # one cotangent block live at a time
    return (*loo_fused._param_grads(sums, sig, log_length, log_noise_sq), w)


class ArdFoldStatsStream(torch.autograd.Function):
    """(e [k, nb], hld [k], inv_diag [k, nb], a [n]) of the fold conditionals
    (:func:`ard_fold_stats_stream`)."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, fold_k, want_inv_diag,
                block):
        nb = _check_folds(x.shape[0], fold_k)
        saved, _ = loo_fused._forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block)
        Kinv, a = saved[:2]
        e = a.new_empty((fold_k, nb))
        hld = a.new_empty((fold_k,))
        inv_diag = a.new_zeros((fold_k, nb))
        for f in range(fold_k):
            s = slice(f * nb, (f + 1) * nb)
            La = linalg.chol_factor(Kinv[s, s])
            hld[f] = linalg.half_logdet(La)
            e[f] = linalg.chol_solve_from_factor(La, a[s, None])[:, 0]
            if want_inv_diag:
                X = _tri_inverse(La)
                del La
                inv_diag[f] = torch.sum(X.square_(), dim=0)
        ctx.fold_k, ctx.want_inv_diag = fold_k, want_inv_diag
        ctx.save_for_backward(*saved, e)
        return e, hld, inv_diag, a

    @staticmethod
    def backward(ctx, e_bar, hld_bar, d_bar, a_bar):
        e = ctx.saved_tensors[6]
        nb = e.shape[1]

        def fold_cot(f, A):
            X = _tri_inverse(linalg.chol_factor(A))
            Ainv = matmul(X.mT, X)
            del X
            u = matmul(Ainv, e_bar[f][:, None])[:, 0]
            c_h = 0.5 * hld_bar[f]
            if ctx.want_inv_diag:
                d = d_bar[f]
                # A^-1 diag(d_bar) A^-1 in row strips: A^-1 and the block
                # being built, and no third one.
                S = torch.empty_like(Ainv)
                for r0 in range(0, nb, ctx.block):
                    r1 = min(r0 + ctx.block, nb)
                    S[r0:r1] = matmul(Ainv[r0:r1] * d[None, :], Ainv)
                S.sub_(Ainv.mul_(c_h))
            else:
                S = Ainv.mul_(-c_h)
            return S.addr_(u, e[f]), u

        s_bar, l_bar, n_bar, w = _stream_folds(ctx, a_bar.clone(), fold_cot)
        return s_bar, l_bar, n_bar, None, w, None, None, None


class ArdFoldEsStream(torch.autograd.Function):
    """The per-fold energy scores [k] (:func:`ard_fold_es_stream`)."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, eps, fold_k, num_sim, beta,
                block):
        nb = _check_folds(x.shape[0], fold_k)
        saved, _ = loo_fused._forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, block)
        Kinv, a = saved[:2]
        e = a.new_empty((fold_k, nb))
        scores = a.new_empty((fold_k,))
        for f in range(fold_k):
            s = slice(f * nb, (f + 1) * nb)
            La = linalg.chol_factor(Kinv[s, s])
            e[f] = linalg.chol_solve_from_factor(La, a[s, None])[:, 0]
            zT = linalg.tri_solve(La, eps[f], trans=True)
            scores[f] = _es_from_cols(zT, e[f], num_sim, beta)
        ctx.fold_k, ctx.num_sim, ctx.beta = fold_k, num_sim, beta
        ctx.save_for_backward(*saved, e, eps)
        return scores

    @staticmethod
    def backward(ctx, s_bar):
        a, e, eps = ctx.saved_tensors[1], ctx.saved_tensors[6], ctx.saved_tensors[7]

        def fold_cot(f, A):
            La = linalg.chol_factor(A)
            with torch.enable_grad():  # the score arithmetic alone
                zT = linalg.tri_solve(La, eps[f], trans=True).requires_grad_()
                e_f = e[f].detach().requires_grad_()
                score = _es_from_cols(zT, e_f, ctx.num_sim, ctx.beta)
                zT_bar, e_bar = torch.autograd.grad(score, (zT, e_f), s_bar[f])
            u = linalg.chol_solve_from_factor(La, e_bar[:, None])[:, 0]
            G = linalg.tri_solve(La, zT_bar)  # La^-1 Z_bar^T [nb, 2 S]
            # H = eps G^T becomes T = La^-T Phi(H) La^-1 in place: La and H
            # are the whole transient.
            H = matmul(eps[f], G.T).tril_()
            H.diagonal().mul_(0.5)
            torch.linalg.solve_triangular(La.mT, H, upper=True, out=H)
            torch.linalg.solve_triangular(La, H, upper=False, left=False, out=H)
            return H.addr_(u, e[f]), u

        s_bar_, l_bar, n_bar, w = _stream_folds(ctx, torch.zeros_like(a), fold_cot)
        return s_bar_, l_bar, n_bar, None, w, None, None, None, None, None


def ard_fold_stats_stream(log_signal_sq, log_length, log_noise_sq, x, y, fold_k: int,
                          want_inv_diag: bool = True, block=None):
    """Fold-streamed fused k-fold statistics (`fold_stream.py:333-386`) of the
    fold conditionals A_f = [K_hat^-1]_ff, K_hat = K_ard(x) + noise I:

        e [k, nb]        = A_f^-1 [K_hat^-1 y]_f     (the fold mean is y_f - e_f)
        hld [k]          = sum log diag chol(A_f)    (half log-det of the fold precision)
        inv_diag [k, nb] = diag(A_f^-1)              (zeros unless ``want_inv_diag``)
        a [n]            = K_hat^-1 y

    Differentiable in the three log-parameters and y. Raises ``ValueError``
    unless fold_k divides n; a fold that is not SPD gives NaN. ``block``: the
    panel and stream width (None: ``auto_block``)."""
    return ArdFoldStatsStream.apply(log_signal_sq, log_length, log_noise_sq, x, y, fold_k,
                                    want_inv_diag, loo_fused._resolve_block(x, block))


def ard_fold_es_stream(log_signal_sq, log_length, log_noise_sq, x, y, fold_k: int,
                       num_sim: int = 300, beta: float = 1.0, block=None, generator=None,
                       eps=None):
    """Fold-streamed fused k-fold energy score (`fold_stream.py:484-534`): the
    Monte-Carlo energy scores [k] of the fold conditionals, by
    :func:`~gpscore_torch.scoring.rules.energy_score_core` with r = -e and
    z | z' the column halves of La^-T eps_f.

    ``eps`` [k, nb, 2 num_sim] fixes the standard normals, in the JAX
    package's per-fold layout (`fold_core.py:443-449`); else they are drawn
    in that shape from ``generator``, a ``torch.Generator`` on x's device
    (never from the global one: with neither, ``ValueError``). The backward
    must see the forward's normals: they are saved, O(n num_sim) beside the
    n^2 inverse, which costs less code than restoring a generator's state
    per device and serves explicit ``eps`` the same way. (The JAX package
    regenerates them from counter keys, which torch cannot replay.)

    Differentiable in the three log-parameters and y. Raises ``ValueError``
    unless fold_k divides n."""
    nb = _check_folds(x.shape[0], fold_k)
    if eps is None:
        if generator is None:
            raise ValueError("the es core needs eps or a generator")
        eps = torch.randn((fold_k, nb, 2 * num_sim), generator=generator, dtype=x.dtype,
                          device=x.device)
    return ArdFoldEsStream.apply(log_signal_sq, log_length, log_noise_sq, x, y, eps, fold_k,
                                 num_sim, beta, loo_fused._resolve_block(x, block))
