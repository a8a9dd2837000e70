"""Hyperparameters as a dataclass of tensors (port of `gpscore/utils/params.py`).

All scalar hyperparameters are log-parameterized, as in the JAX package:

- ``log_signal_sq``  sigma_k^2 = exp(.)
- ``log_length``     exp(.) is the per-dimension lengthscale for ``ard`` and the
                     *squared* lengthscale for the isotropic ``rbf``
- ``log_noise_sq``   sigma_noise^2 = exp(.)
- ``inducing``       FITC inducing inputs [m, d], or None for the exact GP

A batch of restarts or replicates is one GPParams whose every leaf carries a
leading [R] (log_signal_sq [R], log_length [R, d], inducing [R, m, d]):
:func:`stack_params` builds one, :func:`select_params` takes restart i out,
:func:`batch_size` reads R.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpscore_torch.utils import checkpoint

FIELDS = ("log_signal_sq", "log_length", "log_noise_sq", "inducing")


@dataclasses.dataclass
class GPParams:
    log_signal_sq: torch.Tensor  # scalar []
    log_length: torch.Tensor  # [d] for ARD, [] for isotropic rbf
    log_noise_sq: torch.Tensor  # scalar []
    inducing: Optional[torch.Tensor] = None  # [m, d] or None

    @property
    def signal_sq(self):
        return torch.exp(self.log_signal_sq)

    @property
    def noise_sq(self):
        return torch.exp(self.log_noise_sq)

    def replace(self, **kw) -> "GPParams":
        return dataclasses.replace(self, **kw)

    def leaves(self) -> dict:
        """The tensors that are present, by field name (``inducing`` may be None)."""
        return {f: getattr(self, f) for f in FIELDS if getattr(self, f) is not None}


def batch_size(p: GPParams) -> Optional[int]:
    """R of a batch of parameters (leaves [R, ...]), None for one set: read
    off log_signal_sq, a scalar unbatched."""
    return p.log_signal_sq.shape[0] if p.log_signal_sq.dim() > 0 else None


def stack_params(ps) -> GPParams:
    """The batch of the parameter sets ``ps`` (each unbatched), leaves [R, ...]."""
    return ps[0].replace(**{f: torch.stack([getattr(p, f) for p in ps])
                            for f in ps[0].leaves()})


def select_params(p: GPParams, i: int) -> GPParams:
    """Restart ``i`` of a batch of parameters."""
    return p.replace(**{f: t[i] for f, t in p.leaves().items()})


def init_unit_params(
    d: int = 1, isotropic: bool = True, inducing=None, device="cpu"
) -> GPParams:
    """Unit init of the synthetic scripts: all log-params = 1.0."""
    dtype = torch.float32
    shape = () if isotropic else (d,)
    return GPParams(
        log_signal_sq=torch.ones((), dtype=dtype, device=device),
        log_length=torch.ones(shape, dtype=dtype, device=device),
        log_noise_sq=torch.ones((), dtype=dtype, device=device),
        inducing=inducing,
    )


def init_rand_params(
    generator: torch.Generator,
    d: int,
    num_inducing: int = 0,
    unit_scalars: bool = False,
    inducing_init: str = "uniform",
    batch: Optional[int] = None,
) -> GPParams:
    """Random init of the KIN40K scripts (`kin40k-FULL-compare.py:226-233`):
    log lengths ~ U(0, 1)^d; log signal and log noise ~ U(0, 1), or 1.0 with
    ``unit_scalars`` (`:321-324`); ``num_inducing`` inducing points ~ U(0, 1),
    or N(0, 1) with ``inducing_init="normal"``
    (`KIN40K-COMPARE-ALL-FITC-20.py:215, 531`).

    Drawn from ``generator``, on its device, in that order. The values are not
    the JAX package's threefry draws of the same distributions. ``batch`` R
    draws R restarts at once, each leaf [R, ...], in the same order (all R
    log lengths first)."""
    opts = dict(dtype=torch.float32, device=generator.device, generator=generator)
    lead = () if batch is None else (batch,)
    log_length = torch.rand((*lead, d), **opts)
    if unit_scalars:
        log_signal = torch.ones(lead, dtype=torch.float32, device=generator.device)
        log_noise = torch.ones(lead, dtype=torch.float32, device=generator.device)
    else:
        log_signal = torch.rand(lead, **opts)
        log_noise = torch.rand(lead, **opts)
    inducing = None
    if num_inducing > 0:
        draw = torch.randn if inducing_init == "normal" else torch.rand
        inducing = draw((*lead, num_inducing, d), **opts)
    return GPParams(log_signal, log_length, log_noise, inducing)


def save_params_checkpoint(path: str, p: GPParams) -> None:
    """Write ``p`` with :func:`~gpscore_torch.utils.checkpoint.save_pytree`
    (the layout of JAX ``save_pytree`` of a GPParams): ``leaf_i`` for the
    present fields in field order, no ``inducing`` leaf when it is None.
    Leaves may carry a leading replicate dimension."""
    checkpoint.save_pytree(path, p)


def params_from_checkpoint(path: str) -> GPParams:
    """Read a GPParams checkpoint written by JAX ``save_pytree`` (e.g. a
    sweep's ``--save-params`` output) or by :func:`save_params_checkpoint`:
    three leaves for the exact GP, four with the inducing points. The tensors
    land on the CPU."""
    leaves = checkpoint.load_leaves(path)
    if len(leaves) not in (3, 4):
        raise ValueError(f"a GPParams checkpoint has 3 or 4 leaves, {path} has {len(leaves)}")
    return params_from_numpy(dict(zip(FIELDS, leaves)))


def params_from_numpy(arrays: dict, device="cpu") -> GPParams:
    """GPParams from numpy arrays (or nested lists) keyed by field name, as
    float32 tensors on ``device``. ``inducing`` may be absent or None."""

    def conv(v):
        if v is None:
            return None
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return GPParams(**{f: conv(arrays.get(f)) for f in FIELDS})


def params_to_numpy(p: GPParams) -> dict:
    """Field name -> numpy array (None stays None)."""
    return {
        f: None if getattr(p, f) is None else getattr(p, f).detach().cpu().numpy()
        for f in FIELDS
    }
