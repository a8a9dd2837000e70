"""Full-batch gradient descent (port of `gpscore/fit/train.py::fit_gd`).

The JAX package compiles the whole fit as one ``lax.scan``; here it is an
eager Python loop. Each iteration does one ``torch.autograd.grad`` and a
masked update under ``no_grad``, and writes the loss into a history that
stays on the device, so the loop never waits on the host.

Fault tolerance as in the JAX package: an iteration whose loss or gradient is
not finite (a failed Cholesky gives NaN, see
:func:`gpscore_torch.ops.linalg.chol_factor`) skips its update, and
``stall_iters`` counts the skipped iterations that end the fit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gpscore_torch.utils.params import FIELDS, GPParams


class FitResult(NamedTuple):
    params: GPParams
    loss_history: torch.Tensor  # [iters]
    ok: torch.Tensor  # scalar bool: True if any iteration produced a finite loss
    param_history: Optional[GPParams] = None  # [iters, ...]-leaved, if recorded
    # Trailing consecutive iterations whose update was skipped (non-finite
    # loss or gradient): > 0 means the fit ended frozen at its last good
    # parameters. 0 on a healthy fit.
    stall_iters: Optional[torch.Tensor] = None


def fit_gd(
    loss_fn,
    params: GPParams,
    x,
    y,
    iters: int,
    lr: float,
    lr_inducing: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    skip_nonfinite: bool = True,
    record_params: bool = False,
) -> FitResult:
    """Full-batch gradient descent with a separate inducing-point learning
    rate (the reference's ``learning_rate2``, `SIMPLE-FITC--comapre.py:318-319`).

    ``generator`` feeds stochastic objectives (energy score); it advances every
    iteration, so each step draws fresh samples, as the JAX package's per-step
    ``fold_in`` does (with other numbers: threefry is not replayed).

    ``record_params=True`` also returns the per-iteration parameters as a
    ``[iters]``-leading GPParams: ``param_history[i]`` is the evaluation point
    of ``loss_history[i]`` (pre-update); the final parameters are ``params``.
    """
    if lr_inducing is None:
        lr_inducing = lr
    rates = {f: (lr_inducing if f == "inducing" else lr) for f in FIELDS}
    leaves = {f: t.detach() for f, t in params.leaves().items()}
    device = x.device
    losses = torch.empty((iters,), dtype=x.dtype, device=device)
    stall = torch.zeros((), dtype=torch.int32, device=device)
    history = {f: [] for f in leaves}
    for i in range(iters):
        cur = {f: t.detach().requires_grad_() for f, t in leaves.items()}
        loss = loss_fn(params.replace(**cur), x, y, generator)
        grads = torch.autograd.grad(loss, list(cur.values()))
        with torch.no_grad():
            # One scalar probe: max(|.|) propagates NaN and surfaces Inf, and
            # cannot overflow on large finite gradients as a sum could.
            probe = torch.abs(loss)
            for g in grads:
                probe = torch.maximum(probe, torch.max(torch.abs(g)))
            finite = torch.isfinite(probe)
            stall = torch.where(finite, torch.zeros_like(stall), stall + 1)
            new = {}
            for (f, t), g in zip(cur.items(), grads):
                upd = t - rates[f] * g
                new[f] = torch.where(finite, upd, t) if skip_nonfinite else upd
            losses[i] = loss
            if record_params:
                for f, t in cur.items():
                    history[f].append(t.detach())
        leaves = new
    final = params.replace(**leaves)
    param_history = None
    if record_params:
        param_history = params.replace(
            **{f: torch.stack(h) if h else None for f, h in history.items()}
        )
    ok = torch.any(torch.isfinite(losses))
    return FitResult(final, losses, ok, param_history, stall)
