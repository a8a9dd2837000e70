"""One (rule, replicate) fit, then the test-set metrics (port of
`experiments/common.py::{fit_and_eval, eval_predictive_metrics}`), and the
same for a batch of replicates as one batched fit (the JAX sweep's
``jax.vmap`` of ``fit_and_eval``)."""

from __future__ import annotations

from typing import List, Optional

import torch

from gpscore_torch.fit import objectives
from gpscore_torch.fit.objectives import make_objective
from gpscore_torch.fit.schedules import Schedule
from gpscore_torch.fit.train import FitResult, fit_gd
from gpscore_torch.metrics import EvalMetrics, evaluate_predictive
from gpscore_torch.models.exact import exact_predictive
from gpscore_torch.models.fitc import fitc_predictive
from gpscore_torch.ops.kernels import gram
from gpscore_torch.parallel.sweeps import restart_sweep
from gpscore_torch.utils.params import GPParams, batch_size, select_params
from gpscore_torch.utils.precision import matmul_mode


def eval_predictive_metrics(
    model: str, p: GPParams, train_x, train_y, test_x, test_y, kernel: str = "ard"
) -> EvalMetrics:
    """The six-metric suite of the test predictive at fitted params. The exact
    GP builds its three Grams (train x train, test x train, test x test)
    through the Gram kernel. Always in the "highest" precision mode: a
    reduced mode is for the fit's iterations only, as in the JAX package."""
    if model not in ("exact", "fitc"):
        raise ValueError(f"unknown model {model!r}")
    with torch.no_grad(), matmul_mode("highest"):
        if model == "exact":
            sig, ll = p.log_signal_sq, p.log_length
            k_ff = gram(train_x, train_x, sig, ll, kind=kernel)
            k_sf = gram(test_x, train_x, sig, ll, kind=kernel)
            k_ss = gram(test_x, test_x, sig, ll, kind=kernel)
            pred = exact_predictive(k_sf, k_ff, k_ss, train_y, p.noise_sq)
        else:
            pred = fitc_predictive(train_x, train_y, test_x, p, kind=kernel)
        var = torch.diagonal(pred.cov)
        return evaluate_predictive(pred.mean, var, test_y, train_y)


def fit_and_eval(
    rule: str,
    model: str,
    schedule: Schedule,
    params0: GPParams,
    train_x,
    train_y,
    test_x,
    test_y,
    generator: Optional[torch.Generator] = None,
    kernel: str = "ard",
    fold_k: int = 4,
    num_sim: int = 300,
) -> tuple[EvalMetrics, FitResult]:
    """Fit by GD on the schedule, then evaluate the test predictive.

    The fit takes ``fit_gd``'s default (replayed from a CUDA graph on a card)
    except where the exact objective takes the fused large-n cores: there the
    card is busy throughout an eager step, and a captured step would hold its
    n x n temporaries in the graph's pool for the whole fit."""
    loss = make_objective(rule, model=model, kernel=kernel, fold_k=fold_k, num_sim=num_sim)
    fused = model == "exact" and train_x.shape[0] >= objectives._FUSED_LOO_MIN_N
    res = fit_gd(
        loss,
        params0,
        train_x,
        train_y,
        iters=schedule.iters,
        lr=schedule.lr,
        lr_inducing=schedule.lr_inducing,
        generator=generator,
        graph=False if fused else None,
    )
    metrics = eval_predictive_metrics(
        model, res.params, train_x, train_y, test_x, test_y, kernel=kernel
    )
    return metrics, res


def fit_and_eval_batch(
    rule: str,
    model: str,
    schedule: Schedule,
    params0: GPParams,
    train_x,
    train_y,
    test_x,
    test_y,
    generator: Optional[torch.Generator] = None,
    kernel: str = "ard",
    fold_k: int = 4,
    num_sim: int = 300,
) -> tuple[List[EvalMetrics], FitResult]:
    """:func:`fit_and_eval` for R replicates at once: params0 with leaves
    [R, ...], the data [R, ...] per replicate (train_x [R, n, d], train_y
    [R, n], test_x [R, t, d], test_y [R, t]) or shared (without the [R]).

    The fit is :func:`~gpscore_torch.parallel.sweeps.restart_sweep`: one
    batched fit below the exact GP's fused sizes (replayed from one CUDA
    graph on a card), the replicates one after another above. The
    evaluation runs once per replicate, so it loops over them. Returns the
    R replicates' metrics and the batched FitResult ([R, ...] fields);
    ``generator`` draws every replicate's es normals."""
    R = batch_size(params0)
    loss = make_objective(rule, model=model, kernel=kernel, fold_k=fold_k, num_sim=num_sim)
    res = restart_sweep(loss, params0, train_x, train_y, schedule.iters, schedule.lr,
                        schedule.lr_inducing, generator=generator)

    def rep(a, r, rank):
        return a[r] if a.dim() > rank else a

    metrics = [
        eval_predictive_metrics(model, select_params(res.params, r), rep(train_x, r, 2),
                                rep(train_y, r, 1), rep(test_x, r, 2), rep(test_y, r, 1),
                                kernel=kernel)
        for r in range(R)
    ]
    return metrics, res
