"""Shared inputs for the tests that hold gpscore_torch against gpscore.

Inputs are made with numpy from a seed and handed to both packages, so the two
sides see bit-identical data and parameters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpscore.utils.params import GPParams as JaxParams
from gpscore_torch.utils.params import FIELDS, params_from_numpy


def problem(seed=0, n=64, m=6, d=3):
    """Smooth 1-output regression data and FITC parameters, as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(n, d)).astype(np.float32)
    y = (np.sin(2.0 * x.sum(axis=1)) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    params = {
        "log_signal_sq": np.float32(0.3),
        "log_length": (0.2 * rng.standard_normal(d)).astype(np.float32),
        "log_noise_sq": np.float32(-1.5),
        "inducing": rng.uniform(-1.0, 1.0, size=(m, d)).astype(np.float32),
    }
    return x, y, params


def jax_params(p):
    return JaxParams(**{f: None if p.get(f) is None else jnp.asarray(p[f]) for f in FIELDS})


def torch_params(p, requires_grad=False):
    tp = params_from_numpy(p)
    if requires_grad:
        tp = tp.replace(**{f: t.requires_grad_() for f, t in tp.leaves().items()})
    return tp


def t(a):
    """numpy/JAX array -> CPU torch tensor."""
    return torch.as_tensor(np.asarray(a))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol,
    )


def jax_fold_eps(key, folds, nb, m, num_sim):
    """The standard normals jfitc.lowrank_fold_sample draws from ``key``."""
    e1, e2 = [], []
    for k in jax.random.split(key, folds):
        k1, k2 = jax.random.split(k)
        e1.append(np.asarray(jax.random.normal(k1, (num_sim, nb), jnp.float32)))
        e2.append(np.asarray(jax.random.normal(k2, (m, num_sim), jnp.float32)))
    return t(np.stack(e1)), t(np.stack(e2))
