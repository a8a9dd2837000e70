"""Mesh-sharded dense LOO objectives (port of `gpscore/parallel/sharded_loo.py`):
the out-of-place distributed stack, and the fused sharded LOO and NLML steps
(:func:`make_sharded_fused_loo_fit_step`, :func:`make_sharded_fused_nlml_fit_step`).

Every n x n operand stays row-sharded over the mesh's 'data' axis, each rank
holding [n/p, n], and every collective is written out:

- the Gram: this rank's rows against the gathered x, through the Gram
  kernels (:func:`~gpscore_torch.parallel.sharded_gram.sharded_gram`);
- K_hat = K + noise I on the local diagonal entries, in place;
- the solve core (:func:`make_sharded_loo_solve_diag`): the panel Cholesky,
  L^-1 by distributed forward substitution, K_hat^-1's rows by one reduce
  per row block, a = K_hat^-1 y and diag(K_hat^-1) gathered; its backward
  sends K_hat^-1's row blocks round the ranks for the right-hand product;
- the scoring on the replicated (a, d), plain autodiff;
- the Gram's backward through the two backward kernels on the local rows,
  which leaves each rank the parameter gradient of its rows: the steps
  all-reduce it over 'data'.

JAX jits these steps once; here a ``make_*`` factory builds the step once
and runs it eagerly (no CUDA graph holds collectives in this port yet).

The fused steps keep only this rank's rows of K_hat^-1 across the step:
their forward is the in-place sharded pipeline
(:func:`~gpscore_torch.parallel.sharded_potri.ard_gram_inverse_inplace_sharded`),
their backward the streamed contraction
(:func:`~gpscore_torch.parallel.sharded_potri.make_streamed_ard_bwd`), one
``torch.autograd.Function`` spanning both; ~n^2/p + O(n b) a rank, at the
precision mode's ``storage_dtype()``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gpscore_torch.fit.objectives import make_objective
from gpscore_torch.parallel.mesh import Mesh, all_reduce_sum, broadcast, gather_rows
from gpscore_torch.parallel.sharded_cholesky import (add_noise_sharded,
                                                     sharded_cholesky, sharded_half_logdet,
                                                     sharded_inverse_from_linv,
                                                     sharded_tri_inverse_lower,
                                                     sharded_tri_solve_lower)
from gpscore_torch.parallel.sharded_gram import sharded_gram
from gpscore_torch.parallel.sharded_potri import (ard_gram_inverse_inplace_sharded,
                                                  make_streamed_ard_bwd, sharded_diag)
from gpscore_torch.scoring import rules
from gpscore_torch.utils.params import GPParams
from gpscore_torch.utils.precision import addmm_, matmul, matmul_acc32, storage_dtype, upcast

LOO_RULES = ("crps", "logs", "interval")


def default_block(rows_per: int, block: Optional[int] = None) -> int:
    """The panel width: ``block`` as given, else the largest power of two up
    to 256 that divides a rank's rows (JAX's GSPMD path takes no panel)."""
    return block if block is not None else math.gcd(rows_per, 256)


def sharded_inverse(K_local, mesh: Mesh, axis: str = "data", block: int = 256):
    """This rank's rows of K^-1 for SPD K, row-sharded ([n/p, n] in and
    out): factor, L^-1, then L^-T L^-1, with the factor and L^-1 freed as soon
    as the next one exists."""
    L = sharded_cholesky(K_local, mesh, axis, block)
    X = sharded_tri_inverse_lower(L, mesh, axis, block)
    del L
    return sharded_inverse_from_linv(X, mesh, axis)


def _local_diag(S_local, mesh: Mesh, axis: str):
    return S_local.diagonal(offset=mesh.index(axis) * S_local.shape[0])


def sub_times_S(out, M_local, S_local, mesh: Mesh, axis: str = "data"):
    """out -= M S for the row-sharded symmetric S and this rank's rows M_local
    [n/p, n] of M: sum_t M_local[:, block t] S_t, where S_t, rank t's rows
    of S, is broadcast to every rank in turn (p broadcasts of [n/p, n])."""
    rows_per = S_local.shape[0]
    me = mesh.index(axis)
    for t in range(mesh.size(axis)):
        S_t = S_local if t == me else S_local.new_empty(S_local.shape)
        if mesh.size(axis) > 1:
            broadcast(S_t, t, mesh, axis)
        addmm_(out, M_local[:, t * rows_per:(t + 1) * rows_per], S_t, alpha=-1.0)
        del S_t
    return out


def _solve_grads(S, a, a_bar, mesh, axis):
    """(K_bar rows less their second term, y_bar): -(S a_bar) a^T on the
    local rows and the gathered S a_bar."""
    w_local = matmul(S, a_bar[:, None])[:, 0]
    K_bar = torch.outer(w_local, a).neg_()
    return K_bar, gather_rows(w_local, mesh, axis)


class _ShardedLooSolveDiag(torch.autograd.Function):
    """(a, d) = (K^-1 y, diag(K^-1)), replicated, for the row-sharded K."""

    @staticmethod
    def forward(ctx, K_local, y, mesh, axis, block):
        S = sharded_inverse(K_local, mesh, axis, block)
        a = gather_rows(matmul(S, y[:, None])[:, 0], mesh, axis)
        d = gather_rows(_local_diag(S, mesh, axis).contiguous(), mesh, axis)
        ctx.save_for_backward(S, a)
        ctx.mesh, ctx.axis = mesh, axis
        return a, d

    @staticmethod
    def backward(ctx, a_bar, d_bar):
        S, a = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        K_bar, y_bar = _solve_grads(S, a, a_bar, mesh, axis)
        sub_times_S(K_bar, S * d_bar[None, :], S, mesh, axis)
        return K_bar, y_bar, None, None, None


def make_sharded_loo_solve_diag(mesh: Mesh, axis: str = "data", block: int = 256):
    """Distributed :class:`gpscore_torch.ops.linalg.LooSolveDiag`:
    ``f(K_local, y) -> (K^-1 y, diag(K^-1))`` for SPD K with rows sharded
    over ``axis`` (K_local [n/p, n], y [n] replicated), both outputs
    replicated, a ``torch.autograd.Function`` whose forward and backward
    issue the collectives. The backward's closed-form adjoints, on the
    local rows:

        K_bar = -(K^-1 a_bar) a^T - (K^-1 * d_bar[None, :]) K^-1

    with the right-hand K^-1 sent round the ranks a row block at a time, so
    no rank holds more than a few [n/p, n] arrays."""

    def f(K_local, y):
        return _ShardedLooSolveDiag.apply(K_local, y.reshape(-1), mesh, axis, block)

    return f


def sharded_loo_moments(k_ff, y, noise_sq, mesh: Mesh, axis: str = "data", block: int = 256):
    """Distributed LOO moments (mean, var) of the exact GP, replicated: K_hat
    on the local rows of ``k_ff`` [n/p, n] (copied), the panel Cholesky, L^-1
    and K_hat^-1's rows, then the Rasmussen-Williams identities on the
    gathered a = K_hat^-1 y and diag(K_hat^-1). Forward-only."""
    with torch.no_grad():
        K_hat = add_noise_sharded(k_ff.clone(), noise_sq, mesh, axis)
        a, d = _ShardedLooSolveDiag.apply(K_hat, y.reshape(-1), mesh, axis, block)
    y = y.reshape(-1)
    return y - a / d, 1.0 / d


class _ShardedNlml(torch.autograd.Function):
    """NLML of the row-sharded K_hat, replicated: the value from
    :func:`~gpscore_torch.parallel.sharded_cholesky.sharded_nlml`'s chain
    (factor, forward substitution, half log-det), the K_hat cotangent
    v_bar (K_hat^-1 - a a^T) / 2 from the solve core's K_hat^-1."""

    @staticmethod
    def forward(ctx, K_local, y, mesh, axis, block):
        n = K_local.shape[-1]
        L = sharded_cholesky(K_local, mesh, axis, block)
        w = sharded_tri_solve_lower(L, y, mesh, axis, block)
        value = (0.5 * n * math.log(2.0 * math.pi) + sharded_half_logdet(L, mesh, axis)
                 + 0.5 * torch.sum(w * w))
        X = sharded_tri_inverse_lower(L, mesh, axis, block)
        del L
        S = sharded_inverse_from_linv(X, mesh, axis)
        del X
        a = gather_rows(matmul(S, y[:, None])[:, 0], mesh, axis)
        ctx.save_for_backward(S, a)
        ctx.row0 = mesh.index(axis) * S.shape[0]
        return value

    @staticmethod
    def backward(ctx, v_bar):
        S, a = ctx.saved_tensors
        a_local = a[ctx.row0:ctx.row0 + S.shape[0]]
        K_bar = S.clone().addr_(a_local, a, alpha=-1.0).mul_(0.5 * v_bar)
        return K_bar, v_bar * a, None, None, None


def _exact_loss(rule, p, x, y, mesh, axis, block, kernel, fold_k, num_sim, es_beta,
                generator):
    """The replicated exact-GP loss of ``rule`` on the row-sharded stack, x
    this rank's rows, y [n] replicated."""
    from gpscore_torch.parallel.sharded_kfold import KFOLD_RULES, _fold_loss, _kfold_core

    K_hat = add_noise_sharded(sharded_gram(x, p.log_signal_sq, p.log_length, mesh, axis,
                                           kind=kernel), p.noise_sq, mesh, axis)
    if rule in LOO_RULES:
        a, d = _ShardedLooSolveDiag.apply(K_hat, y, mesh, axis, block)
        mean, var = y - a / d, 1.0 / d
        if rule == "crps":
            return rules.crps_gaussian(mean, var, y)
        if rule == "logs":
            return rules.logs_gaussian(mean, var, y)
        return rules.interval_score(mean, var, y)
    if rule == "nlml":
        return _ShardedNlml.apply(K_hat, y, mesh, axis, block)
    if rule in KFOLD_RULES:
        mean, La, y_b = _kfold_core(K_hat, y, mesh, axis, block, fold_k)
        return _fold_loss(rule, mean, La, y_b, generator, num_sim, es_beta)
    raise ValueError(f"unknown rule {rule!r}")


def _value_and_grad(loss_of, params: GPParams, mesh: Mesh, axis: str, reduce: bool):
    """(loss, gradient GPParams) of ``loss_of(params)``; with ``reduce`` the
    gradients, partial sums of the local rows, are all-reduced over ``axis``."""
    leaves = {f: t.detach().requires_grad_() for f, t in params.leaves().items()}
    p = params.replace(**leaves)
    loss = loss_of(p)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    if reduce:
        for g in grads:
            all_reduce_sum(g, mesh, axis)
    return loss.detach(), params.replace(**dict(zip(leaves, grads)))


def sharded_loo_value_and_grad(
    params,
    x,
    y,
    mesh: Mesh,
    rule: str = "crps",
    model: str = "exact",
    kernel: str = "ard",
    axis: str = "data",
    generator: Optional[torch.Generator] = None,
    block: Optional[int] = None,
):
    """One (loss, grad) evaluation of a scoring-rule objective with the
    training rows sharded over ``mesh[axis]``: x is this rank's row block,
    y [n] replicated, ``params`` replicated; returns the loss and a GPParams
    of gradients, both replicated.

    The exact GP runs the distributed stack, every rule: crps, logs and
    interval through the LOO solve core; dss, kc and es through the k-fold
    block core (:mod:`~gpscore_torch.parallel.sharded_kfold`); nlml with its
    value from the sharded Cholesky chain and its K_hat cotangent from the
    core's K_hat^-1. ``block``: the panel width (default
    :func:`default_block`). FITC (JAX: GSPMD over the plain objective) runs
    replicated on every rank on the gathered x: no n x n operand exists, and
    its gradient is not reduced. ``generator`` is required by the stochastic
    es rule."""
    if rule == "es" and generator is None:
        raise ValueError("rule='es' is stochastic: pass a generator")
    y = y.reshape(-1)
    if model == "fitc":
        loss = make_objective(rule, model="fitc", kernel=kernel)
        x_full = gather_rows(x, mesh, axis)
        return _value_and_grad(lambda p: loss(p, x_full, y, generator), params, mesh, axis,
                               reduce=False)
    if model != "exact":
        raise ValueError(f"unknown model {model!r}")
    block = default_block(x.shape[0], block)
    # make_objective's fold_k, num_sim and es_beta, which JAX's call leaves at their defaults
    return _value_and_grad(
        lambda p: _exact_loss(rule, p, x, y, mesh, axis, block, kernel, 4, 300, 1.0, generator),
        params, mesh, axis, reduce=True)


def _sgd(params: GPParams, grads: GPParams, lr: float) -> GPParams:
    return params.replace(**{f: (t - lr * getattr(grads, f)).detach()
                             for f, t in params.leaves().items()})


def make_sharded_loo_fit_step(mesh: Mesh, lr: float = 1.0, axis: str = "data",
                              block: int = 256, kernel: str = "ard"):
    """The CRPS-LOO gradient step at large n with every n x n object
    row-sharded: sharded Gram (the kernels), the distributed solve core, CRPS,
    the gradient all-reduced over ``axis``, an SGD update. Returns
    ``step(params, x, y) -> (loss, updated params)``, x this rank's rows, y
    [n] and params replicated. Built once, run eagerly each call."""

    def step(params, x, y):
        y = y.reshape(-1)
        loss, grads = _value_and_grad(
            lambda p: _exact_loss("crps", p, x, y, mesh, axis, block, kernel, 4, 0, 1.0, None),
            params, mesh, axis, reduce=True)
        return loss, _sgd(params, grads, lr)

    return step


def sharded_loo_fit_step(params, x, y, mesh, lr: float = 1.0, axis: str = "data",
                         block: int = 256, kernel: str = "ard"):
    """One step of :func:`make_sharded_loo_fit_step` (which a training loop
    builds once)."""
    return make_sharded_loo_fit_step(mesh, lr=lr, axis=axis, block=block, kernel=kernel)(
        params, x, y)


def _fused_forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, mesh, axis, block):
    """K_hat^-1's rows at the mode's storage and the half log-det; a = K^-1 y
    gathered. Saves what the streamed backward reads: the rows, a, x and the
    three log-parameters."""
    Kinv, hld = ard_gram_inverse_inplace_sharded(log_signal_sq, log_length, log_noise_sq, x, mesh,
                                                 axis, block, storage=storage_dtype())
    a = gather_rows(matmul_acc32(Kinv, y.reshape(-1, 1).to(Kinv.dtype))[:, 0], mesh, axis)
    ctx.save_for_backward(Kinv, a, x, log_signal_sq, log_length, log_noise_sq)
    return Kinv, a, hld


class _ShardedFusedLoo(torch.autograd.Function):
    """(a, d) = (K_hat^-1 y, diag K_hat^-1), replicated, for K_hat =
    K_ard(x) + noise I, x [n, d] replicated; differentiable in the three
    log-parameters and y."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, mesh, axis, block, bwd):
        Kinv, a, _ = _fused_forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, mesh,
                                    axis, block)
        ctx.bwd = bwd
        return a, gather_rows(upcast(sharded_diag(Kinv, mesh, axis)), mesh, axis)

    @staticmethod
    def backward(ctx, a_bar, d_bar):
        s_bar, l_bar, n_bar, w = ctx.bwd(*ctx.saved_tensors, (a_bar, d_bar))
        return s_bar, l_bar, n_bar, None, w, None, None, None, None


class _ShardedFusedNlml(torch.autograd.Function):
    """0.5 n log 2pi + 0.5 log det K_hat + 0.5 y^T K_hat^-1 y, replicated,
    the half log-det from the sharded factorization."""

    @staticmethod
    def forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, mesh, axis, block, bwd):
        _, a, hld = _fused_forward(ctx, log_signal_sq, log_length, log_noise_sq, x, y, mesh,
                                   axis, block)
        ctx.bwd = bwd
        return 0.5 * x.shape[0] * math.log(2.0 * math.pi) + hld + 0.5 * torch.dot(y, a)

    @staticmethod
    def backward(ctx, v_bar):
        s_bar, l_bar, n_bar, _ = ctx.bwd(*ctx.saved_tensors, v_bar)
        return s_bar, l_bar, n_bar, None, v_bar * ctx.saved_tensors[1], None, None, None, None


def _fused_step(loss_of, mesh: Mesh, axis: str, lr: float):
    """``step(params, x, y) -> (loss, params - lr grad)`` of ``loss_of(p,
    x_full, y)``, x this rank's rows (gathered once a step); the gradients
    come replicated out of the streamed backward, so nothing is reduced."""

    def step(params, x, y):
        y = y.reshape(-1)
        x_full = gather_rows(x, mesh, axis)
        loss, grads = _value_and_grad(lambda p: loss_of(p, x_full, y), params, mesh, axis,
                                      reduce=False)
        return loss, _sgd(params, grads, lr)

    return step


def make_sharded_fused_loo_fit_step(mesh: Mesh, lr: float = 1.0, axis: str = "data",
                                    block: int = 256, rule: str = "crps"):
    """The fused sharded LOO gradient step of ``rule`` (crps, logs or
    interval): the in-place sharded K_hat^-1, the LOO moments, the rule, the
    streamed backward, an SGD update. Returns ``step(params, x, y) -> (loss,
    updated params)``, x this rank's rows, y [n] and params replicated; n must
    divide by p * block. Built once, run eagerly each call; per rank ~n^2/p +
    O(n block) across the step."""
    score = {"crps": rules.crps_gaussian, "logs": rules.logs_gaussian,
             "interval": rules.interval_score}[rule]
    bwd = make_streamed_ard_bwd(mesh, "loo", axis=axis, block=block)

    def loss_of(p, x, y):
        a, d = _ShardedFusedLoo.apply(p.log_signal_sq, p.log_length, p.log_noise_sq, x, y, mesh,
                                      axis, block, bwd)
        return score(y - a / d, 1.0 / d, y)

    return _fused_step(loss_of, mesh, axis, lr)


def make_sharded_fused_nlml_fit_step(mesh: Mesh, lr: float = 0.0005, axis: str = "data",
                                     block: int = 256):
    """The fused sharded NLML gradient step (reference inline NLML at
    `SIMPLE-DATA FULL-comapre.py:292-296`): the forward of
    :func:`make_sharded_fused_loo_fit_step` with the half log-det free from
    the factorization, and a backward that reads K_hat_bar = v_bar (K^-1 -
    a a^T) / 2 off the local rows: no sandwich product, no collective but
    the final all-reduce. Same contract as the LOO step."""
    bwd = make_streamed_ard_bwd(mesh, "nlml", axis=axis, block=block)

    def loss_of(p, x, y):
        return _ShardedFusedNlml.apply(p.log_signal_sq, p.log_length, p.log_noise_sq, x, y, mesh,
                                       axis, block, bwd)

    return _fused_step(loss_of, mesh, axis, lr)
