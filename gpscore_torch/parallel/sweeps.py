"""Batched multi-restart and multi-replicate sweeps (port of
`gpscore/parallel/sweeps.py::{default_sweep_keys, restart_sweep}`).

The JAX package runs a sweep as one XLA program, ``jax.vmap`` of the whole
GD fit over a leading restart axis. Here the axis is explicit: the restarts
are one batched fit (:func:`gpscore_torch.fit.train.fit_gd_batch`), whose
step computes every restart's loss and gradient in one pass, through the
Gram kernels' batch grid axis, and on a card is captured once as a CUDA graph
and replayed, R restarts in every launch. The restarts share nothing but the
launches: each one's fit is its solo fit's.

``sharded_restart_sweep`` (the restart axis over a device mesh) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from gpscore_torch.fit import objectives
from gpscore_torch.fit.train import FitResult, fit_gd, fit_gd_batch
from gpscore_torch.utils.params import GPParams, batch_size, select_params, stack_params


def default_sweep_generator(device="cpu") -> torch.Generator:
    """A sweep's generator when none is given, the counterpart of
    ``default_sweep_keys``: one ``torch.Generator`` on the data's
    ``device``, seeded 0, from which a stochastic objective (es) draws the
    normals of every restart at once ([R, ...] a step). Its draws are not
    the JAX package's (``fold_in(PRNGKey(0), i)`` per restart, threefry),
    nor split per restart; the two packages' RNG streams cannot agree
    (ROADMAP queue 3)."""
    return torch.Generator(device=device).manual_seed(0)


def _fused(params_batch: GPParams, x) -> bool:
    """Whether an exact objective takes the fused large-n cores at this n,
    which have no batch axis."""
    return params_batch.inducing is None and x.shape[-2] >= objectives._FUSED_LOO_MIN_N


def restart_sweep(
    loss_fn,
    params_batch: GPParams,
    x,
    y,
    iters: int,
    lr: float,
    lr_inducing: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    graph: Optional[bool] = None,
) -> FitResult:
    """R GD fits from the R starts of ``params_batch`` (leaves [R, ...]):
    ``jax.vmap(fit_gd)`` over the leading restart axis (`sweeps.py:32-54`).

    x [n, d] and y [n] are shared by every restart, or x [R, n, d] and y
    [R, n] are each restart's own (a sweep's replicates). ``loss_fn`` is an
    objective of :func:`~gpscore_torch.fit.objectives.make_objective`, which
    returns the R losses for batched parameters. ``generator`` feeds es
    (default: :func:`default_sweep_generator` on the data's device).
    ``graph`` as in :func:`~gpscore_torch.fit.train.fit_gd`.

    Returns a FitResult in ``jax.vmap``'s layout: params [R, ...],
    loss_history [R, iters], ok [R], stall_iters [R].

    Below the exact GP's fused sizes (n < ``objectives._FUSED_LOO_MIN_N``,
    and FITC at every n) the sweep is one batched fit
    (:func:`~gpscore_torch.fit.train.fit_gd_batch`). At the fused sizes the
    fused cores have no batch axis, and the restarts run one after another
    through :func:`~gpscore_torch.fit.train.fit_gd`, each eager unless
    ``graph`` says otherwise (a captured step would hold its n x n
    temporaries for the whole fit), drawing from the one generator in turn.
    """
    R = batch_size(params_batch)
    if R is None:
        raise ValueError("restart_sweep takes parameters whose leaves carry a leading [R]")
    if generator is None:
        generator = default_sweep_generator(x.device)
    if not _fused(params_batch, x):
        return fit_gd_batch(loss_fn, params_batch, x, y, iters, lr, lr_inducing,
                            generator=generator, graph=graph)
    fits = []
    for r in range(R):
        xr = x[r] if x.dim() == 3 else x
        yr = y[r] if y.dim() == 2 else y
        fits.append(fit_gd(loss_fn, select_params(params_batch, r), xr, yr, iters, lr,
                           lr_inducing, generator=generator,
                           graph=False if graph is None else graph))
    return FitResult(stack_params([f.params for f in fits]),
                     torch.stack([f.loss_history for f in fits]),
                     torch.stack([f.ok for f in fits]), None,
                     torch.stack([f.stall_iters for f in fits]))
