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
  block [r0, r1) two GEMMs ([b, nb] x [nb, nb], then [b, nb] x [nb, r1], the
  second operand a view of the symmetric K^-1's rows: the lower
  block-triangle, as in the LOO core) and the two Gram backward kernels.
  A_bar_f is freed before the next fold. a_bar is complete only
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
(dK_hat/dtheta is symmetric). The single-device backward streams the lower
block-triangle, which reads that part alone, so its fold cotangents are made
symmetric first: u e^T enters as (u e^T + e u^T) / 2, and the es core's
A_bar is symmetrized in place, one [b, b] tile pair at a time. The sharded
backward (:mod:`gpscore_torch.parallel.sharded_fold_stream`) streams full
rows and takes the cotangents as they are.

Blocks of nb^2 live beside K^-1, at most: the forward holds one (the factor;
two with ``want_inv_diag``), the dss backward two while it forms A^-1, the kc
and es backward two; every stream holds one. The JAX module forms the
explicit factor inverse and its own in-place fold stages, pads the blocks to
a panel grid and sums the rank-1 term through a separate Gram pass, for XLA
and its chip; here the folds go to cuSOLVER and cuBLAS trsm as they are.

Precision (:mod:`gpscore_torch.utils.precision`): in the "bf16"/"f16" modes
K^-1 is 2-byte (`fold_stream.py:162-192`). Each fold's block is upcast to
fp32 and factored there by cuSOLVER, one fp32 fold transient at a time (the
JAX package's "per-fold fp32 upcast transients only"); everything per fold
is fp32. The fold cotangent is rounded to the storage dtype before the
sandwich, whose two products are native 2-byte passes with fp32 output, the
first rounded again (`:245-253`); the es normals are rounded to the storage
dtype (`:523`, `:561`). In fp32 storage the code is the same, with every
rounding a no-op.
"""

from __future__ import annotations

import torch

from gpscore_torch.ops import linalg, loo_fused
from gpscore_torch.utils import profiling
from gpscore_torch.utils.precision import TWO_BYTE, matmul, matmul_acc32, upcast


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


def _fold_stats(A, a_f, want_inv_diag: bool):
    """(e_f, hld_f, diag(A^-1) or None) of one fold from its fp32 block A =
    [K^-1]_ff and a_f = [K^-1 y]_f: the factor, the fold's half log-det of
    the precision, e_f = A^-1 a_f; the factor is the one nb^2 transient."""
    La = linalg.chol_factor(A)
    hld = linalg.half_logdet(La)
    e = linalg.chol_solve_from_factor(La, a_f[:, None])[:, 0]
    if not want_inv_diag:
        return e, hld, None
    X = _tri_inverse(La)
    del La
    return e, hld, torch.sum(X.square_(), dim=0)


def _stats_fold_cot(A, e_f, e_bar_f, hld_bar_f, d_bar_f, block: int):
    """(-A_bar_f, u = A^-1 e_bar_f) of one fold of the stats core (module
    docstring), from its fp32 block A; ``d_bar_f`` None when the inverse
    diagonal is not an output."""
    nb = A.shape[0]
    X = _tri_inverse(linalg.chol_factor(A))
    Ainv = matmul(X.mT, X)
    del X
    u = matmul(Ainv, e_bar_f[:, None])[:, 0]
    c_h = 0.5 * hld_bar_f
    if d_bar_f is not None:
        # A^-1 diag(d_bar) A^-1 in row strips: A^-1 and the block being
        # built, and no third one.
        S = torch.empty_like(Ainv)
        for r0 in range(0, nb, block):
            r1 = min(r0 + block, nb)
            S[r0:r1] = matmul(Ainv[r0:r1] * d_bar_f[None, :], Ainv)
        S.sub_(Ainv.mul_(c_h))
    else:
        S = Ainv.mul_(-c_h)
    return S.addr_(u, e_f), u


def _fold_es(A, a_f, eps_f, num_sim: int, beta: float):
    """(energy score, e_f) of one fold from its fp32 block A, a_f and its
    normals eps_f [nb, 2 num_sim]."""
    La = linalg.chol_factor(A)
    e = linalg.chol_solve_from_factor(La, a_f[:, None])[:, 0]
    zT = linalg.tri_solve(La, eps_f, trans=True)
    return _es_from_cols(zT, e, num_sim, beta), e


def _symmetrize_(S, tile: int):
    """S <- (S + S^T) / 2 in place, one [tile, tile] transient at a time."""
    m = S.shape[0]
    for i0 in range(0, m, tile):
        for j0 in range(0, i0 + 1, tile):
            lo, up = S[i0:i0 + tile, j0:j0 + tile], S[j0:j0 + tile, i0:i0 + tile]
            t = torch.add(lo, up.mT).mul_(0.5)
            lo.copy_(t)
            up.copy_(t.mT)
    return S


def _es_fold_cot(A, e_f, eps_f, s_bar_f, num_sim: int, beta: float):
    """(-A_bar_f, u) of one fold of the es core (module docstring) from its
    fp32 block A and the forward's e_f and normals."""
    La = linalg.chol_factor(A)
    with torch.enable_grad():  # the score arithmetic alone
        zT = linalg.tri_solve(La, eps_f, trans=True).requires_grad_()
        e_ = e_f.detach().requires_grad_()
        score = _es_from_cols(zT, e_, num_sim, beta)
        zT_bar, e_bar = torch.autograd.grad(score, (zT, e_), s_bar_f)
    u = linalg.chol_solve_from_factor(La, e_bar[:, None])[:, 0]
    G = linalg.tri_solve(La, zT_bar)  # La^-1 Z_bar^T [nb, 2 S]
    # H = eps G^T becomes T = La^-T Phi(H) La^-1 in place: La and H are the
    # whole transient.
    H = matmul(eps_f, G.T).tril_()
    H.diagonal().mul_(0.5)
    torch.linalg.solve_triangular(La.mT, H, upper=True, out=H)
    torch.linalg.solve_triangular(La, H, upper=False, left=False, out=H)
    return H.addr_(u, e_f), u


def _stream_folds(ctx, a_bar, fold_cot):
    """The shared backward: (log_signal_bar, log_length_bar, log_noise_bar,
    y_bar). ``fold_cot(f, A_f)`` returns fold f's (-A_bar_f [nb, nb], a fresh
    tensor; u [nb]); ``a_bar`` [n] is the cotangent of the
    output a, and is updated in place."""
    Kinv, a, xs, sig, log_noise_sq, log_length = ctx.saved_tensors[:6]
    k, st = ctx.fold_k, Kinv.dtype
    nb = a.shape[0] // k
    sums, w = None, None
    for f in range(k):
        s = slice(f * nb, (f + 1) * nb)
        S, u = fold_cot(f, upcast(Kinv[s, s]))
        S = S.to(st)  # rounded once before the sandwich
        a_bar[s] += u
        if f == k - 1:  # a_bar is complete: the rank-1 term rides this pass
            w = loo_fused._w(Kinv, a_bar)

        def rows_of(r0, r1):  # rows of -K^-1[:, f] A_bar_f K^-1[f, :], columns [0, r1)
            return matmul_acc32(matmul_acc32(Kinv[r0:r1, s], S).to(st),
                                loo_fused.lower_cols(Kinv, r1, s))

        part = loo_fused._stream_param_grads(rows_of, w, a, xs, sig, ctx.block)
        sums = part if sums is None else tuple(p + q for p, q in zip(sums, part))
        del S, rows_of  # one cotangent block live at a time
    return (*loo_fused._param_grads(sums, sig, log_length, log_noise_sq), w)


class ArdFoldStatsStream(torch.autograd.Function):
    """(e [k, nb], hld [k], inv_diag [k, nb], a [n]) of the fold conditionals
    (:func:`ard_fold_stats_stream`)."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, fold_k, want_inv_diag,
                block):
        nb = _check_folds(x.shape[0], fold_k)
        with profiling.span("core.forward", x.device, core="fold_stats", n=x.shape[0],
                            block=block):
            saved, _ = loo_fused._forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y,
                                          block)
            Kinv, a = saved[:2]
            e = a.new_empty((fold_k, nb))
            hld = a.new_empty((fold_k,))
            inv_diag = a.new_zeros((fold_k, nb))
            for f in range(fold_k):
                s = slice(f * nb, (f + 1) * nb)
                e[f], hld[f], d = _fold_stats(upcast(Kinv[s, s]), a[s], want_inv_diag)
                if want_inv_diag:
                    inv_diag[f] = d
            ctx.fold_k, ctx.want_inv_diag = fold_k, want_inv_diag
            ctx.save_for_backward(*saved, e)
            return e, hld, inv_diag, a

    @staticmethod
    def backward(ctx, e_bar, hld_bar, d_bar, a_bar):
        e = ctx.saved_tensors[6]

        def fold_cot(f, A):  # made symmetric: u e^T becomes (u e^T + e u^T) / 2
            S, u = _stats_fold_cot(A, e[f], e_bar[f], hld_bar[f],
                                   d_bar[f] if ctx.want_inv_diag else None, ctx.block)
            return S.addr_(u, e[f], alpha=-0.5).addr_(e[f], u, alpha=0.5), u

        with profiling.span("core.backward", e.device, core="fold_stats", passes=ctx.fold_k,
                            cols="lower"):
            s_bar, l_bar, n_bar, w = _stream_folds(ctx, a_bar.clone(), fold_cot)
        return s_bar, l_bar, n_bar, None, w, None, None, None


class ArdFoldEsStream(torch.autograd.Function):
    """The per-fold energy scores [k] (:func:`ard_fold_es_stream`)."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, eps, fold_k, num_sim, beta,
                block):
        nb = _check_folds(x.shape[0], fold_k)
        with profiling.span("core.forward", x.device, core="fold_es", n=x.shape[0], block=block):
            saved, _ = loo_fused._forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y,
                                          block)
            Kinv, a = saved[:2]
            if Kinv.dtype in TWO_BYTE:
                eps = eps.to(Kinv.dtype).to(eps.dtype)  # the normals in the storage dtype
            e = a.new_empty((fold_k, nb))
            scores = a.new_empty((fold_k,))
            for f in range(fold_k):
                s = slice(f * nb, (f + 1) * nb)
                scores[f], e[f] = _fold_es(upcast(Kinv[s, s]), a[s], eps[f], num_sim, beta)
            ctx.fold_k, ctx.num_sim, ctx.beta = fold_k, num_sim, beta
            ctx.save_for_backward(*saved, e, eps)
            return scores

    @staticmethod
    def backward(ctx, s_bar):
        a, e, eps = ctx.saved_tensors[1], ctx.saved_tensors[6], ctx.saved_tensors[7]

        def fold_cot(f, A):  # made symmetric
            S, u = _es_fold_cot(A, e[f], eps[f], s_bar[f], ctx.num_sim, ctx.beta)
            return _symmetrize_(S, ctx.block), u

        with profiling.span("core.backward", a.device, core="fold_es", passes=ctx.fold_k,
                            cols="lower"):
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
