"""Batched multi-restart and multi-replicate sweeps (port of
`gpscore/parallel/sweeps.py`).

The JAX package runs a sweep as one XLA program, ``jax.vmap`` of the whole
GD fit over a leading restart axis. Here the axis is explicit: the restarts
are one batched fit (:func:`gpscore_torch.fit.train.fit_gd_batch`), whose
step computes every restart's loss and gradient in one pass, through the
Gram kernels' batch grid axis, and on a card is captured once as a CUDA graph
and replayed, R restarts in every launch. The restarts share nothing but the
launches: each one's fit is its solo fit's.

:func:`sharded_restart_sweep` splits the restart axis over the mesh's
'batch' axis: each rank runs the batched fit of its R/p restarts on the
replicated data, with no collective, and the results are gathered over
'batch' into the layout of :func:`restart_sweep`.
"""

from __future__ import annotations

from typing import Optional

import torch

from gpscore_torch.fit import objectives
from gpscore_torch.fit.train import FitResult, fit_gd, fit_gd_batch
from gpscore_torch.parallel.mesh import Mesh, batch_sharding, gather_rows, place
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


def sharded_restart_sweep(
    loss_fn,
    params_batch: GPParams,
    x,
    y,
    iters: int,
    lr: float,
    mesh: Mesh,
    lr_inducing: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    graph: Optional[bool] = None,
) -> FitResult:
    """:func:`restart_sweep` with the restart axis split over the mesh's
    'batch' axis (`sweeps.py:57-83`): every rank passes the whole
    ``params_batch`` ([R, ...], R divisible by the axis size) and the data
    (x, y, replicated, as JAX places them), fits its own R/p restarts as one
    batched fit (on a card a captured, replayed step, as in
    :func:`restart_sweep`), and returns the whole FitResult, every leaf
    gathered over 'batch' into ``jax.vmap``'s layout. The step issues no
    collective; the ranks of one 'batch' coordinate (a 'data' axis beside
    it) fit the same restarts. ``generator`` draws this rank's restarts' es
    normals (default: :func:`default_sweep_generator`, seeded 0 on every
    rank, so es draws differ from the unsharded sweep's)."""
    R = batch_size(params_batch)
    if R is None:
        raise ValueError("sharded_restart_sweep takes parameters whose leaves carry a leading [R]")
    p = mesh.size("batch")
    if R % p != 0:
        raise ValueError(f"{R} restarts do not split over the {p} ranks of 'batch'")
    shard = batch_sharding(mesh)
    local = params_batch.replace(**{f: place(t, shard).contiguous()
                                    for f, t in params_batch.leaves().items()})
    res = restart_sweep(loss_fn, local, x, y, iters, lr, lr_inducing, generator, graph)

    def gather(t):
        if t is None:
            return None
        if t.dtype == torch.bool:  # gloo gathers no bool
            return gather_rows(t.to(torch.uint8), mesh, "batch").bool()
        return gather_rows(t, mesh, "batch")

    return FitResult(res.params.replace(**{f: gather(t) for f, t in res.params.leaves().items()}),
                     gather(res.loss_history), gather(res.ok),
                     None if res.param_history is None else res.param_history.replace(
                         **{f: gather(t) for f, t in res.param_history.leaves().items()}),
                     gather(res.stall_iters))
