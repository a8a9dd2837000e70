"""Exact-GP predictive distributions: test-time, leave-one-out and k-fold
(port of `gpscore/models/exact.py`, the dense path at small n).

Every quantity of one training step derives from one Cholesky factorization
of K_hat = K_ff + sigma^2 I. Folds ride a leading [k, ...] dimension instead
of ``vmap``; the small-n functions (:func:`loo_exact`, :func:`kfold_exact`,
:func:`kfold_exact_precision`, :func:`nlml_exact`, :func:`exact_predictive`)
also take a batch of restarts or replicates before it: K_ff [R, n, n],
noise_sq [R] and y [n] or [R, n] give [R, ...] results, each batch's its
own. The fused forms stay unbatched. The fold blocks are factored with
:func:`gpscore_torch.ops.linalg.chol_factor`, which gives NaN where JAX's
``jnp.linalg.cholesky`` does (``torch.linalg.cholesky`` would raise, and wait
on the host every step to find out), so ``fit_gd``'s masked update can skip a
failed step.

The fused large-n forms ``loo_exact_fused``, ``nlml_exact_fused``,
``kfold_exact_precision_fused`` and ``exact_predictive_diag_large`` take x and
the parameters instead of K_ff: they go through the cores of
:mod:`gpscore_torch.ops.loo_fused`, whose peak is one n x n buffer.
``kfold_stats_fused`` and ``kfold_es_fused`` go through the fold-streamed
cores of :mod:`gpscore_torch.ops.fold_stream`, which take one fold at a time
off that buffer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpscore_torch.ops import fold_stream, gram_cuda, linalg, loo_fused, potri_inplace
from gpscore_torch.ops.kernels import per_batch
from gpscore_torch.utils.precision import matmul


class Gaussian(NamedTuple):
    """A (possibly diagonal) Gaussian predictive: mean [n] and cov, which is
    [n] (diagonal variances) or [n, n] (full covariance). Leading dimensions,
    where present, are folds."""

    mean: torch.Tensor
    cov: torch.Tensor


class PrecisionGaussian(NamedTuple):
    """Gaussian in precision form: cov = (chol_prec chol_prec^T)^-1, the k-fold
    block conditionals' natural output (the block A_b = [K_hat^-1]_bb is
    available; its inverse is never formed). Leading dimensions are folds."""

    mean: torch.Tensor  # [..., nb]
    chol_prec: torch.Tensor  # [..., nb, nb] lower


class FoldStats(NamedTuple):
    """Statistics of the k-fold block conditionals A_f = [K_hat^-1]_ff, one
    row per fold: e = A_f^-1 [K_hat^-1 y]_f (the fold mean is y_f - e), the
    half log-det of the fold precision A_f, and diag(A_f^-1), the fold
    variances (zeros where they were not asked for)."""

    e: torch.Tensor  # [k, nb]
    half_logdet: torch.Tensor  # [k]
    inv_diag: torch.Tensor  # [k, nb]


def _sites(y, n: int):
    """y as [n], or [R, n] for per-replicate targets."""
    return y.reshape(n) if y.numel() == n else y.reshape(-1, n)


def _k_hat(k_ff, noise_sq):
    eye = torch.eye(k_ff.shape[-1], dtype=k_ff.dtype, device=k_ff.device)
    return k_ff + per_batch(noise_sq, 2) * eye


def exact_predictive(k_star_f, k_ff, k_ss, y, noise_sq, *, L=None) -> Gaussian:
    """Noise-inclusive exact GP predictive (reference ``cal_mean_and_cov``,
    `SIMPLE-DATA FULL-comapre.py:106-111`):

        mu*  = K*f (Kff + s^2 I)^-1 y
        Cov* = s^2 I + K** - K*f (Kff + s^2 I)^-1 Kf*
    """
    n = k_ff.shape[-1]
    if L is None:
        L = linalg.chol_factor(_k_hat(k_ff, noise_sq))
    alpha = linalg.chol_solve_from_factor(L, _sites(y, n)[..., None])
    mean = matmul(k_star_f, alpha)[..., 0]
    V = linalg.tri_solve(L, k_star_f.mT)  # [..., n, t]
    eye_t = torch.eye(k_ss.shape[-1], dtype=k_ss.dtype, device=k_ss.device)
    cov = per_batch(noise_sq, 2) * eye_t + k_ss - matmul(V.mT, V)
    return Gaussian(mean, cov)


def exact_predictive_diag_large(x, y, x_test, params, *, block=None,
                                chunk: int = 2048, storage=None, refine: int = 0) -> Gaussian:
    """Diagonal of the noise-inclusive exact predictive at large n, ARD
    kernel (`gpscore/models/exact.py:66-203`): the mean and variances of
    :func:`exact_predictive`, with K_ff never formed. The factor L of K_hat
    comes from the in-place pipeline's first stage
    (:func:`~gpscore_torch.ops.potri_inplace.ard_gram_chol_inplace`); the
    test points stream in ``chunk`` columns, each a Gram kernel launch
    K(x, x*) [n, chunk] and a triangular solve V = L^-1 K(x, x*), so the
    t x t covariance never exists:

        mean* = K(x, x*)^T K_hat^-1 y,   var* = noise + signal - sum_i V_i^2

    The JAX function multiplies K(x, x*) by the explicit inverse instead,
    because XLA's triangular solve with an [n, chunk] right-hand side held
    more temporaries than its chip had (its docstring); here the solve is
    one cuBLAS trsm with O(n chunk) memory. The factor also keeps the
    variance accurate: k*^T (K_hat^-1 k*) off the explicit fp32 inverse
    cancels, and at n = 30,720 with crps-fitted parameters it was 9.7% of
    the largest variance off the dense form on an NVIDIA H100 80GB HBM3
    (700 W) (1.4e-3 at n = 8192 against an fp64 solve on the CPU, where the
    factor's sum of squares is 5e-7).

    ``storage`` (bfloat16 or float16) keeps L in 2 bytes, for fits beyond
    the fp32 buffer's ceiling: the solves are then blocked substitutions
    (:func:`~gpscore_torch.ops.potri_inplace.tri_solve_stored`), and the
    metrics are 2-byte grade. ``refine`` > 0 (with ``storage``) runs that
    many iterations of the JAX function's safeguarded preconditioned CG on
    every solve (`exact.py:136-181`): the preconditioner M = L^-T L^-1
    through the 2-byte factor, the operator the exact K_hat, recomputed in
    fp32 panels (:func:`~gpscore_torch.ops.potri_inplace.ard_khat_matmul_streamed`),
    steps whose curvature pq is not positive and finite masked per column,
    and the iterate of the least residual returned; the variance is then
    noise + signal - k*^T (K_hat^-1 k*) off the refined solve. Without
    ``storage``, ``refine`` is ignored, as in the JAX function.

    ``block`` is the Cholesky's panel width (None: ``auto_block``, as the
    fused cores take it). Peak ~n^2 (half of it with ``storage``) +
    O(n chunk); refinement holds six fp32 [n, chunk] iterates. Not
    differentiable."""
    st = torch.float32 if storage is None else storage
    with torch.no_grad():
        block = loo_fused._resolve_block(x, block)
        lp = (params.log_signal_sq, params.log_length, params.log_noise_sq, x)
        L, _ = potri_inplace.ard_gram_chol_inplace(*lp, block, storage=st)
        xs = gram_cuda.scale_inputs(x, params.log_length)
        sig = params.signal_sq
        if st == torch.float32:
            def half_solve(B):
                return linalg.tri_solve(L, B)

            def solve(B):
                return linalg.chol_solve_from_factor(L, B)
        else:
            def half_solve(B):
                return potri_inplace.tri_solve_stored(L, B, block)

            def precond(R):
                return potri_inplace.tri_solve_stored(L, half_solve(R), block, trans=True)

            def solve(B):
                return _pcg(precond, lambda V: potri_inplace.ard_khat_matmul_streamed(
                    *lp[:3], x, V, block), B, refine)
        alpha = solve(y.reshape(-1, 1))[:, 0]
        means, variances = [], []
        for c0 in range(0, x_test.shape[0], chunk):
            xt = gram_cuda.scale_inputs(x_test[c0:c0 + chunk], params.log_length)
            ks = gram_cuda.gram_fwd(xs, xt, sig)  # [n, chunk]
            means.append(matmul(alpha[None, :], ks)[0])
            if st != torch.float32 and refine > 0:
                quad = torch.sum(ks * solve(ks), dim=0)
            else:
                V = half_solve(ks)
                quad = torch.sum(V * V, dim=0)
            variances.append(params.noise_sq + sig - quad)
        return Gaussian(torch.cat(means), torch.cat(variances))


def _pcg(precond, khat_mul, B, iters: int):
    """K_hat^-1 B [n, c] by ``iters`` steps of preconditioned CG from X =
    M B, batched over columns, safeguarded as the JAX function is
    (`exact.py:136-181`): a step whose pq is not positive and finite (a
    converged column's roundoff) is masked for that column, and the iterate
    of the least residual norm is returned, never worse than M B."""
    X = precond(B)
    if iters <= 0:
        return X
    R = B - khat_mul(X)
    Z = precond(R)
    P, Xb, rb = Z, X, torch.sum(R * R, dim=0)
    for _ in range(iters):
        Q = khat_mul(P)
        rz = torch.sum(R * Z, dim=0)
        pq = torch.sum(P * Q, dim=0)
        ok = (pq > 1e-30) & torch.isfinite(pq) & torch.isfinite(rz)
        a = torch.where(ok, rz / torch.where(ok, pq, torch.ones_like(pq)), torch.zeros_like(pq))
        X = X + a * P
        R = R - a * Q
        Z = precond(R)
        rz2 = torch.sum(R * Z, dim=0)
        okb = ok & (rz.abs() > 1e-30) & torch.isfinite(rz2)
        beta = torch.where(okb, rz2 / torch.where(okb, rz, torch.ones_like(rz)),
                           torch.zeros_like(rz))
        P = Z + beta * P
        rn = torch.sum(R * R, dim=0)
        better = rn < rb
        Xb = torch.where(better, X, Xb)
        rb = torch.where(better, rn, rb)
    return Xb


def loo_exact(k_ff, y, noise_sq) -> Gaussian:
    """Leave-one-out predictive via the Rasmussen–Williams identities
    (reference `SIMPLE-DATA FULL-comapre.py:207-211`):

        mu_i      = y_i - [K_hat^-1 y]_i / [K_hat^-1]_ii
        sigma_i^2 = 1 / [K_hat^-1]_ii

    K_hat^-1 y and diag(K_hat^-1) come from
    :func:`~gpscore_torch.ops.linalg.loo_solve_diag` and its closed-form
    backward. A diagonal Gaussian over the n training points."""
    y = _sites(y, k_ff.shape[-1])
    kinv_y, kinv_diag = linalg.loo_solve_diag(_k_hat(k_ff, noise_sq), y)
    return Gaussian(y - kinv_y / kinv_diag, 1.0 / kinv_diag)


def loo_exact_fused(x, y, params, block=None) -> Gaussian:
    """:func:`loo_exact` through the fused ARD-Gram + solve core
    (:func:`~gpscore_torch.ops.loo_fused.ard_loo_solve_diag`): K_ff never
    persists, the forward inverts in one n x n buffer and the backward streams
    the kernel contraction (`gpscore/models/exact.py:227-242`). ``block``:
    the core's panel width (None: ``auto_block``)."""
    y = y.reshape(x.shape[0])
    kinv_y, kinv_diag = loo_fused.ard_loo_solve_diag(
        params.log_signal_sq, params.log_length, params.log_noise_sq, x, y, block)
    return Gaussian(y - kinv_y / kinv_diag, 1.0 / kinv_diag)


def _kfold_blocks(k_ff, y, noise_sq, fold_k: int):
    """Shared k-fold preamble (reference `kin40k-FULL-compare.py:500-530`): the
    diagonal blocks A_b = [K_hat^-1]_bb [k, nb, nb], the fold targets y_b
    [k, nb] and [K_hat^-1 y]_b [k, nb, 1] (each after the batch's [R]). Raises
    ``ValueError`` unless fold_k divides n
    (:class:`~gpscore_torch.ops.linalg.KfoldSolveBlocks` checks)."""
    n = k_ff.shape[-1]
    nb = n // fold_k
    y = _sites(y, n)
    kinv_y, A = linalg.kfold_solve_blocks(_k_hat(k_ff, noise_sq), y, fold_k)
    return (A, y.reshape(*y.shape[:-1], fold_k, nb),
            kinv_y.reshape(*kinv_y.shape[:-1], fold_k, nb, 1))


def kfold_exact(k_ff, y, noise_sq, fold_k: int, *, diag_only: bool = False) -> Gaussian:
    """k-fold block conditionals in covariance form:

        m_b   = y_b - A_b^-1 [K_hat^-1 y]_b
        Cov_b = A_b^-1      (its diagonal with ``diag_only``, the "kc" variant)

    mean [k, nb]; cov [k, nb, nb] or [k, nb]."""
    A, y_b, kinv_y_b = _kfold_blocks(k_ff, y, noise_sq, fold_k)
    Ainv = linalg.spd_inverse(L=linalg.chol_factor(A))
    mean = y_b - matmul(Ainv, kinv_y_b)[..., 0]
    if diag_only:
        return Gaussian(mean, torch.diagonal(Ainv, dim1=-2, dim2=-1))
    return Gaussian(mean, Ainv)


def kfold_exact_precision(k_ff, y, noise_sq, fold_k: int) -> PrecisionGaussian:
    """k-fold block conditionals in precision form (the math of
    :func:`kfold_exact`, with the per-fold inverse never formed):

        A_b = [K_hat^-1]_bb = La_b La_b^T
        m_b = y_b - A_b^-1 [K_hat^-1 y]_b   (one solve with La_b)
    """
    A, y_b, kinv_y_b = _kfold_blocks(k_ff, y, noise_sq, fold_k)
    La = linalg.chol_factor(A)
    mean = y_b - linalg.chol_solve_from_factor(La, kinv_y_b)[..., 0]
    return PrecisionGaussian(mean, La)


def kfold_exact_precision_fused(x, y, params, fold_k: int, block=None) -> PrecisionGaussian:
    """:func:`kfold_exact_precision` through the fused ARD-Gram + k-fold
    solve core (:func:`~gpscore_torch.ops.loo_fused.ard_kfold_solve_blocks`,
    `gpscore/models/exact.py:304-330`)."""
    n = x.shape[0]
    y = y.reshape(n)
    a, A = loo_fused.ard_kfold_solve_blocks(
        params.log_signal_sq, params.log_length, params.log_noise_sq, x, y, fold_k, block)
    nb = n // fold_k
    La = linalg.chol_factor(A)
    mean = y.reshape(fold_k, nb) - linalg.chol_solve_from_factor(
        La, a.reshape(fold_k, nb, 1))[..., 0]
    return PrecisionGaussian(mean, La)


def kfold_stats_fused(x, y, params, fold_k: int, want_inv_diag: bool = True, block=None):
    """The fold statistics of the large-n dss and kc objectives through the
    fold-streamed core (:func:`~gpscore_torch.ops.fold_stream.ard_fold_stats_stream`,
    `gpscore/models/exact.py:333-365`): the fold conditionals of
    :func:`kfold_exact_precision`, factored, scored and differentiated one
    fold at a time off K_hat^-1, with no [fold_k, nb, nb] tensor at any
    point. ``want_inv_diag=False`` skips the fold variances (only kc reads
    them). Returns ``(stats: FoldStats, a_b [k, nb], y_b [k, nb])``; the fold
    mean is ``y_b - stats.e``."""
    n = x.shape[0]
    y = y.reshape(n)
    e, hld, inv_diag, a = fold_stream.ard_fold_stats_stream(
        params.log_signal_sq, params.log_length, params.log_noise_sq, x, y, fold_k,
        want_inv_diag, block)
    return FoldStats(e, hld, inv_diag), a.reshape(e.shape), y.reshape(e.shape)


def kfold_es_fused(x, y, params, fold_k: int, num_sim: int = 300, es_beta: float = 1.0,
                   block=None, generator=None, eps=None):
    """The large-n es objective through the fold-streamed core
    (:func:`~gpscore_torch.ops.fold_stream.ard_fold_es_stream`,
    `gpscore/models/exact.py:368-386`): the summed Monte-Carlo energy score
    of the fold conditionals. ``eps`` [fold_k, nb, 2 num_sim] fixes the
    normals; else they are drawn from ``generator``."""
    return torch.sum(fold_stream.ard_fold_es_stream(
        params.log_signal_sq, params.log_length, params.log_noise_sq, x,
        y.reshape(x.shape[0]), fold_k, num_sim, es_beta, block, generator, eps))


def nlml_exact_fused(x, y, params, block=None):
    """:func:`nlml_exact` through the fused core
    (:func:`~gpscore_torch.ops.loo_fused.ard_nlml`): the factorization runs in
    one n x n buffer and the gradient reads K_hat_bar = (K^-1 - a a^T) / 2 off
    K^-1's rows, with no second n^3 GEMM (`gpscore/models/exact.py:389-401`)."""
    return loo_fused.ard_nlml(params.log_signal_sq, params.log_length, params.log_noise_sq,
                              x, y.reshape(x.shape[0]), block)


def nlml_exact(k_ff, y, noise_sq):
    """Negative log marginal likelihood (reference
    `SIMPLE-DATA FULL-comapre.py:292-296`):

        0.5 n log 2pi + sum log diag(chol(K_hat)) + 0.5 y^T K_hat^-1 y
    """
    n = k_ff.shape[-1]
    y = _sites(y, n)[..., None]
    L = linalg.chol_factor(_k_hat(k_ff, noise_sq))
    quad = 0.5 * torch.sum(y * linalg.chol_solve_from_factor(L, y), dim=(-2, -1))
    return 0.5 * n * math.log(2.0 * math.pi) + linalg.half_logdet(L) + quad
