"""FITC / SPGP sparse-GP posteriors (port of `gpscore/models/fitc.py`).

The low-rank structure is used throughout:

    Q_ff = V V^T,  V = K_fu L_uu^{-T},  L_uu = chol(K_uu + 1e-3 I)
    B    = G + V V^T,  G = diag(k_ff_diag - q_ff_diag + noise_sq)

and every quantity (solves, inverse diagonal, log-det, k-fold blocks,
predictive) goes through the Woodbury identity in O(n m^2):

    B^-1 = G^-1 - W W^T,   W = G^-1 V L_M^{-T},   M = I + V^T G^-1 V.

``jax.vmap`` over folds becomes a leading [k, ...] fold dimension, and
``jax.vmap`` over restarts or replicates a leading [R, ...] batch dimension
before it: parameters with leaves [R, ...] (inducing [R, m, d]), x [n, d]
shared or [R, n, d], y [n] or [R, n]; every term then carries the batch
([R, n, m], [R, k, nb, m], ...), each restart's its own. The JAX
package's parity-only forms (``fitc_dense_cov``, ``kfold_fitc``,
``kfold_fitc_precision``, ``loo_fitc(method="dense")``) are not ported: the
JAX copies are their oracle.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gpscore_torch.models.exact import Gaussian, _sites
from gpscore_torch.ops import linalg
from gpscore_torch.ops.kernels import gram, kernel_diag, per_batch
from gpscore_torch.utils.precision import matmul

KUU_JITTER = 1e-3  # reference `Q`, `SIMPLE-DATA FULL-comapre.py:53`


class FITCTerms(NamedTuple):
    """Everything needed about B = Q_ff + G, in low-rank form."""

    V: torch.Tensor  # [..., n, m]   Qff = V V^T
    g: torch.Tensor  # [..., n]      diagonal of G
    kff_diag: torch.Tensor  # [..., n]
    L_uu: torch.Tensor  # [..., m, m]  chol(K_uu + jitter I)
    L_M: torch.Tensor  # [..., m, m]  chol(I + V^T G^-1 V)
    W: torch.Tensor  # [..., n, m]   B^-1 = diag(1/g) - W W^T


def _eye(m, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


def fitc_terms(x, params, *, kind: str = "ard") -> FITCTerms:
    """Build the Woodbury decomposition of B = Q_ff + G from data + params."""
    u = params.inducing
    m = u.shape[-2]
    K_uu = gram(u, u, params.log_signal_sq, params.log_length, kind=kind)
    K_uu = K_uu + KUU_JITTER * _eye(m, K_uu)
    K_fu = gram(x, u, params.log_signal_sq, params.log_length, kind=kind)
    # Each (factor, solve) pair is one op: on a card, at small m, two kernels
    # (linalg.chol_solve_small).
    L_uu, Vt = linalg.chol_solve_small(K_uu, K_fu.mT)
    V = Vt.mT  # [..., n, m]
    kff_diag = kernel_diag(x, params.log_signal_sq)
    qff_diag = torch.sum(V * V, dim=-1)
    g = kff_diag - qff_diag + per_batch(params.noise_sq, 1)
    Vg = V / g[..., None]
    M = _eye(m, V) + matmul(V.mT, Vg)
    # W^T = L_M^-1 (G^-1 V)^T  =>  W = G^-1 V L_M^-T, so W W^T = G^-1 V M^-1 V^T G^-1.
    L_M, Wt = linalg.chol_solve_small(M, Vg.mT)
    W = Wt.mT  # [..., n, m]
    return FITCTerms(V=V, g=g, kff_diag=kff_diag, L_uu=L_uu, L_M=L_M, W=W)


def _b_inv_apply(t: FITCTerms, r):
    """B^-1 r for r [..., n, k] in O(n m k)."""
    rg = r / t.g[..., None]
    return rg - matmul(t.W, matmul(t.W.mT, r))


def _b_inv_diag(t: FITCTerms):
    return 1.0 / t.g - torch.sum(t.W * t.W, dim=-1)


def fitc_half_logdet(t: FITCTerms):
    """0.5 log det B = sum log diag(L_M) + 0.5 sum log g (determinant lemma)."""
    return linalg.half_logdet(t.L_M) + 0.5 * torch.sum(torch.log(t.g), dim=-1)


def nlml_fitc(x, y, params, *, kind: str = "ard"):
    """FITC NLML: 0.5 n log 2pi + 0.5 log det B + 0.5 y^T B^-1 y."""
    n = x.shape[-2]
    t = fitc_terms(x, params, kind=kind)
    yc = _sites(y, n)[..., None]
    quad = 0.5 * torch.sum(yc * _b_inv_apply(t, yc), dim=(-2, -1))
    return 0.5 * n * math.log(2.0 * math.pi) + fitc_half_logdet(t) + quad


def loo_fitc(
    x, y, params, *, kind: str = "ard", variance_correction: bool = False
) -> Gaussian:
    """FITC leave-one-out predictive, Woodbury method:

        mu_i      = y_i - [B^-1 y]_i / [B^-1]_ii
        sigma_i^2 = 1 / [B^-1]_ii

    ``variance_correction=True`` applies the logs-objective variant of the
    reference (`KIN40K-COMPARE-ALL-FITC-20.py:441-446`),
    sigma_i^2 = 1/[B^-1]_ii + noise_sq - B_ii + Kff_ii, which is algebraically
    zero (B_ii = kff_ii + noise_sq) and kept, computed literally, for parity.
    """
    y = _sites(y, x.shape[-2])
    t = fitc_terms(x, params, kind=kind)
    b_diag = _b_inv_diag(t)
    b_y = _b_inv_apply(t, y[..., None])[..., 0]
    noise_sq = per_batch(params.noise_sq, 1)
    big_q_diag = t.kff_diag + noise_sq  # q_ii + g_ii, exactly
    mean = y - b_y / b_diag
    var = 1.0 / b_diag
    if variance_correction:
        var = var + noise_sq - big_q_diag + t.kff_diag
    return Gaussian(mean, var)


def fitc_predictive(x, y, x_star, params, *, kind: str = "ard") -> Gaussian:
    """FITC predictive (reference ``spgp_cal_mean_and_cov``,
    `SIMPLE-FITC--comapre.py:59-66`):

        mu*  = Q*f B^-1 y
        Cov* = s^2 I + K** - Q*f B^-1 Qf*

    in O(n m^2 + t m^2 + t^2 m) via Q*f = V* V^T and V^T B^-1 V = C - C M^-1 C
    with C = M - I.
    """
    nt = x_star.shape[-2]
    y = _sites(y, x.shape[-2])[..., None]
    t = fitc_terms(x, params, kind=kind)
    K_su = gram(x_star, params.inducing, params.log_signal_sq, params.log_length, kind=kind)
    V_s = linalg.tri_solve(t.L_uu, K_su.mT).mT  # [..., t, m]
    vby = matmul(t.V.mT, _b_inv_apply(t, y))  # [..., m, 1]
    mean = matmul(V_s, vby)[..., 0]
    eye_m = _eye(t.V.shape[-1], t.V)
    M = matmul(t.L_M, t.L_M.mT)
    C = M - eye_m
    CMinvC = matmul(C, linalg.chol_solve_from_factor(t.L_M, C))
    vbv = C - CMinvC
    K_ss = gram(x_star, x_star, params.log_signal_sq, params.log_length, kind=kind)
    noise_sq = per_batch(params.noise_sq, 2)
    cov = noise_sq * _eye(nt, K_ss) + K_ss - matmul(V_s, matmul(vbv, V_s.mT))
    # Roundoff guard: every exact FITC predictive variance is >= noise_sq, but
    # the C - C M^-1 C cancellation can push a few diagonal entries below it at
    # large m. Clamp the diagonal to the bound; off-diagonals are untouched.
    d = torch.diagonal(cov, dim1=-2, dim2=-1)
    cov = cov + torch.diag_embed(torch.clamp(per_batch(params.noise_sq, 1) - d, min=0.0))
    return Gaussian(mean, cov)


def _fitc_fold_terms(x, y, params, fold_k: int, kind: str):
    """Shared FITC k-fold preamble: Woodbury terms reshaped to fold batches
    (W_b [..., k, nb, m], g_b [..., k, nb], y_b [..., k, nb], [B^-1 y]_b
    [..., k, nb])."""
    n = x.shape[-2]
    if n % fold_k != 0:
        raise ValueError(f"n={n} not divisible by fold_k={fold_k}")
    nb = n // fold_k
    y = _sites(y, n)
    t = fitc_terms(x, params, kind=kind)
    b_y = _b_inv_apply(t, y[..., None])[..., 0]

    def folds(v):
        return v.reshape(*v.shape[:-1], fold_k, nb)

    return (
        t.W.reshape(*t.W.shape[:-2], fold_k, nb, t.W.shape[-1]),
        folds(t.g),
        folds(y),
        folds(b_y),
    )


class LowRankPrecisionGaussian(NamedTuple):
    """Per-fold Gaussian whose *precision* is diagonal-minus-low-rank:

        A_b = diag(1/g_b) - W_b W_b^T,  covariance = A_b^-1,

    the FITC fold block [B^-1]_bb. ``L_Mf`` is chol(I_m - W_b^T diag(g_b) W_b).
    The leading axis is the fold ([R, k, ...] batched)."""

    mean: torch.Tensor  # [..., k, nb]
    g: torch.Tensor  # [..., k, nb]
    W: torch.Tensor  # [..., k, nb, m]
    L_Mf: torch.Tensor  # [..., k, m, m]


def kfold_fitc_lowrank(
    x, y, params, fold_k: int, *, kind: str = "ard"
) -> LowRankPrecisionGaussian:
    """FITC k-fold block conditionals in diagonal-minus-low-rank precision form.

    Mean solve per fold via Woodbury on A_b = D - W W^T with D = diag(1/g_b):
        A_b^-1 v = G v + (G W) M_f^-1 (G W)^T v,   M_f = I - W^T G W,  G = diag(g_b).
    """
    W_b, g_b, y_b, b_y_b = _fitc_fold_terms(x, y, params, fold_k, kind)
    m = W_b.shape[-1]
    GW = W_b * g_b[..., None]  # D^-1 W
    Mf = _eye(m, W_b) - matmul(W_b.mT, GW)  # [k, m, m]
    # w = M_f^-1 (GW)^T b_y [k, m, 1], with the factor, as one op.
    L_Mf, w = linalg.chol_solve_small(Mf, matmul(GW.mT, b_y_b[..., None]), full=True)
    ainv_v = g_b * b_y_b + matmul(GW, w)[..., 0]
    mean = y_b - ainv_v
    return LowRankPrecisionGaussian(mean=mean, g=g_b, W=W_b, L_Mf=L_Mf)


def lowrank_fold_logdet_cov(p: LowRankPrecisionGaussian):
    """log det Cov_b = -log det A_b = sum log g_b - 2 sum log diag(L_Mf). [..., k]."""
    return torch.sum(torch.log(p.g), dim=-1) - 2.0 * torch.sum(
        torch.log(torch.diagonal(p.L_Mf, dim1=-2, dim2=-1)), dim=-1
    )


def lowrank_fold_quad(p: LowRankPrecisionGaussian, r):
    """r^T A_b r = r^T D r - ||W^T r||^2 per fold; r [..., k, nb] -> [..., k]."""
    Wr = matmul(p.W.mT, r[..., None])[..., 0]  # [k, m]
    return torch.sum(r * r / p.g, dim=-1) - torch.sum(Wr * Wr, dim=-1)


def lowrank_fold_cov_diag(p: LowRankPrecisionGaussian):
    """diag(A_b^-1) = g + colsum((L_Mf^-1 (GW)^T)^2) per fold. [..., k, nb]."""
    GW = p.W * p.g[..., None]
    S = linalg.tri_solve(p.L_Mf, GW.mT)  # [k, m, nb]
    return p.g + torch.sum(S * S, dim=-2)


def lowrank_fold_sample(
    p: LowRankPrecisionGaussian,
    num_sim: int,
    *,
    generator: Optional[torch.Generator] = None,
    eps=None,
):
    """num_sim draws z ~ N(0, A_b^-1) per fold in O(nb (m + S)):
    A^-1 = G + U Mf^-1 U^T with U = GW, so z = G^1/2 e1 + U L_Mf^-T e2.

    The standard normals come from ``generator``, or are given as
    ``eps = (e1 [k, S, nb], e2 [k, m, S])`` (the tests pass the JAX package's
    draws this way). Returns [k, num_sim, nb]; batched, [R, k, num_sim, nb]
    from [R, k, ...] normals drawn at once from the one generator.
    """
    *lead, nb, m = p.W.shape
    if eps is None:
        opts = dict(dtype=p.W.dtype, device=p.W.device, generator=generator)
        e1 = torch.randn((*lead, num_sim, nb), **opts)
        e2 = torch.randn((*lead, m, num_sim), **opts)
    else:
        e1, e2 = eps
    GW = p.W * p.g[..., None]
    corr = matmul(GW, linalg.tri_solve(p.L_Mf, e2, trans=True))  # [..., k, nb, S]
    return torch.sqrt(p.g)[..., None, :] * e1 + corr.mT
