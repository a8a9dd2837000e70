"""Mesh-sharded k-fold objectives, dss / es / kc (port of
`gpscore/parallel/sharded_kfold.py`): the out-of-place distributed stack,
and the fused sharded step (:func:`make_sharded_fused_kfold_fit_step`), which
dispatches to the fold-streamed one of
:mod:`~gpscore_torch.parallel.sharded_fold_stream`.

The distributed dense stack of :mod:`~gpscore_torch.parallel.sharded_loo`
(sharded Gram, panel Cholesky, L^-1 by distributed substitution, K_hat^-1's
rows) extended to the k-fold block conditionals (reference
`kin40k-FULL-compare.py:497-543`; single-device form
``models.exact.kfold_exact_precision``). Every n x n operand stays
row-sharded; only the [k, nb, nb] fold blocks of K_hat^-1 (n^2 / k
elements, the objective's own working set) are gathered, every rank taking
the fold columns of its own rows.

Split of labour, as in JAX: a ``torch.autograd.Function``
``(K_hat, y) -> (K_hat^-1 y, A)`` with ``A[b] = [K_hat^-1]_bb``, the only
O(n^3) piece, distributed forward and backward; the per-fold scoring
(batched nb x nb Cholesky and the precision-form rules) is plain autodiff
over the port's ``rules`` and ``linalg``, as JAX's ``_fold_loss``.
"""

from __future__ import annotations

from typing import Optional

import torch

from gpscore_torch.ops import linalg
from gpscore_torch.parallel.mesh import Mesh, gather_rows
from gpscore_torch.parallel.sharded_loo import (_exact_loss, _sgd, _solve_grads, _value_and_grad,
                                                sharded_inverse, sub_times_S)
from gpscore_torch.scoring import rules
from gpscore_torch.utils.precision import matmul

KFOLD_RULES = ("dss", "es", "kc")


def _fold_band(S_local, row0: int, nb: int):
    """[rows, nb]: each local row's entries in its own fold's columns (rank
    r's rows of the stacked fold blocks)."""
    rows = S_local.shape[0]
    band = S_local.new_empty((rows, nb))
    for f in range(row0 // nb, (row0 + rows - 1) // nb + 1):
        lo, hi = max(f * nb, row0) - row0, min((f + 1) * nb, row0 + rows) - row0
        band[lo:hi] = S_local[lo:hi, f * nb:(f + 1) * nb]
    return band


class _ShardedKfoldBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K_local, y, mesh, axis, block, fold_k):
        n = K_local.shape[-1]
        if n % fold_k != 0:
            raise ValueError(f"n={n} not divisible by fold_k={fold_k}")
        nb = n // fold_k
        S = sharded_inverse(K_local, mesh, axis, block)
        row0 = mesh.index(axis) * S.shape[0]
        a = gather_rows(matmul(S, y[:, None])[:, 0], mesh, axis)
        A = gather_rows(_fold_band(S, row0, nb), mesh, axis).reshape(fold_k, nb, nb)
        ctx.save_for_backward(S, a)
        ctx.mesh, ctx.axis, ctx.nb = mesh, axis, nb
        return a, A

    @staticmethod
    def backward(ctx, a_bar, A_bar):
        S, a = ctx.saved_tensors
        mesh, axis, nb = ctx.mesh, ctx.axis, ctx.nb
        K_bar, y_bar = _solve_grads(S, a, a_bar, mesh, axis)
        SB = torch.empty_like(S)  # this rank's rows of S blockdiag(A_bar)
        for f in range(A_bar.shape[0]):
            cols = slice(f * nb, (f + 1) * nb)
            SB[:, cols] = matmul(S[:, cols], A_bar[f])
        sub_times_S(K_bar, SB, S, mesh, axis)
        return K_bar, y_bar, None, None, None, None


def make_sharded_kfold_blocks(mesh: Mesh, fold_k: int, axis: str = "data", block: int = 256):
    """Distributed ``f(K_local, y) -> (K_hat^-1 y, A)``, A the stacked
    diagonal blocks [K_hat^-1]_bb [k, nb, nb] (reference
    `kin40k-FULL-compare.py:507-511`), both replicated, for SPD K_hat with
    rows sharded over ``axis`` (K_local [n/p, n], y [n] replicated). Backward
    (S = K_hat^-1, B = blockdiag(A_bar)), on the local rows:

        y_bar = S a_bar,   K_bar = -(S a_bar) a^T - S B S

    S B one [n/p, nb] x [nb, nb] product a fold, then S's row blocks sent
    round the ranks for the right-hand product; no n x n operand on a rank.
    Raises ``ValueError`` unless fold_k divides n."""

    def f(K_local, y):
        return _ShardedKfoldBlocks.apply(K_local, y.reshape(-1), mesh, axis, block, fold_k)

    return f


def _kfold_core(K_hat, y, mesh, axis, block, fold_k):
    """Fold means, precision factors and targets ([k, nb], [k, nb, nb],
    [k, nb]) from the row-sharded K_hat, as ``exact.kfold_exact_precision``
    computes them: m_b = y_b - A_b^-1 [K_hat^-1 y]_b, A_b = La_b La_b^T."""
    a, A = _ShardedKfoldBlocks.apply(K_hat, y, mesh, axis, block, fold_k)
    nb = y.shape[0] // fold_k
    La = linalg.chol_factor(A)
    y_b = y.reshape(fold_k, nb)
    mean = y_b - linalg.chol_solve_from_factor(La, a.reshape(fold_k, nb, 1))[..., 0]
    return mean, La, y_b


def _fold_loss(rule: str, mean, La, y_b, generator, num_sim: int, es_beta: float):
    """Precision-form fold scoring, the exact branches of
    ``fit.objectives`` (dss and es: the fold sum; kc: ``crps_kfold``)."""
    if rule == "dss":
        return torch.sum(rules.dss_precision(mean, La, y_b))
    if rule == "kc":
        return rules.crps_kfold(mean, linalg.inv_diag_from_chol(La), y_b)
    return torch.sum(rules.energy_score_precision(mean, La, y_b, num_sim, es_beta,
                                                  generator=generator))


def make_sharded_kfold_fit_step(
    mesh: Mesh,
    rule: str = "dss",
    fold_k: int = 4,
    lr: float = 0.001,
    axis: str = "data",
    block: int = 256,
    kernel: str = "ard",
    num_sim: int = 300,
    es_beta: float = 1.0,
):
    """The k-fold gradient step at large n with every n x n object
    row-sharded: sharded Gram, the distributed block core, the per-fold
    precision-form scoring, the gradient all-reduced over ``axis``, an SGD
    update. Returns ``step(params, x, y, generator=None) -> (loss, updated
    params)``, x this rank's rows, y [n] and params replicated; the
    stochastic es rule needs ``generator``. Built once, run eagerly each call."""
    if rule not in KFOLD_RULES:
        raise ValueError(f"rule must be one of {KFOLD_RULES}, got {rule!r}")

    def step(params, x, y, generator: Optional[torch.Generator] = None):
        if rule == "es" and generator is None:
            raise ValueError("rule='es' is stochastic: pass a generator")
        y = y.reshape(-1)
        loss, grads = _value_and_grad(
            lambda p: _exact_loss(rule, p, x, y, mesh, axis, block, kernel, fold_k, num_sim,
                                  es_beta, generator), params, mesh, axis, reduce=True)
        return loss, _sgd(params, grads, lr)

    return step


def make_sharded_fused_kfold_fit_step(
    mesh: Mesh,
    rule: str = "dss",
    fold_k: int = 4,
    lr: float = 0.001,
    axis: str = "data",
    block: int = 256,
    num_sim: int = 300,
    es_beta: float = 1.0,
    streamed: bool = True,
):
    """The fused sharded k-fold gradient step: with ``streamed`` (JAX's
    default) the fold-streamed step,
    :func:`~gpscore_torch.parallel.sharded_fold_stream.make_sharded_streamed_kfold_fit_step`,
    with its contract (``step(params, x, y, generator=None, eps=None)``).
    ``streamed=False``, JAX's stacked form, is a parity oracle that the port
    does not carry (ROADMAP.md, "Not to port"): ``NotImplementedError``."""
    if rule not in KFOLD_RULES:
        raise ValueError(f"rule must be one of {KFOLD_RULES}, got {rule!r}")
    if not streamed:
        raise NotImplementedError(
            "streamed=False, the stacked fused k-fold step, is not ported (ROADMAP.md, 'Not to "
            "port'): it is JAX's parity form, superseded by the fold-streamed step")
    from gpscore_torch.parallel.sharded_fold_stream import make_sharded_streamed_kfold_fit_step

    return make_sharded_streamed_kfold_fit_step(mesh, rule=rule, fold_k=fold_k, lr=lr, axis=axis,
                                                block=block, num_sim=num_sim, es_beta=es_beta)
