"""KIN40K loading with the reference's subsampling protocol (port of
`gpscore/data/kin40k.py`).

- :func:`load_kin40k` reads the reference's ``.xlsx`` workbook (sheets
  trainx/trainy/testx/testy), an ``.npz`` with those keys, or a directory of
  ``.csv`` files; with no file it synthesizes the same KIN40K-shaped stand-in
  as the JAX package, with numpy alone.
- :func:`kin40k_replicate_split` reproduces the per-replicate protocol
  (`kin40k-FULL-compare.py:194-214`). It draws with
  ``np.random.default_rng(replicate * 100)`` exactly as the JAX package does,
  so both packages train and test on the same rows.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpscore_torch.utils.params import GPParams, params_from_numpy


class Kin40k(NamedTuple):
    train_x: np.ndarray  # [N_pool, 8]
    train_y: np.ndarray  # [N_pool]
    test_x: np.ndarray  # [N_test, 8]
    test_y: np.ndarray  # [N_test]


class ReplicateSplit(NamedTuple):
    train_x: torch.Tensor
    train_y: torch.Tensor
    va_x: torch.Tensor
    va_y: torch.Tensor
    test_x: torch.Tensor
    test_y: torch.Tensor


def synthesize_kin40k_like(
    seed: int = 0, n_pool: int = 10_000, n_test: int = 5_000, d: int = 8
) -> Kin40k:
    """Hermetic stand-in with KIN40K's shape and a smooth nonlinear response
    (robot-arm-like composition of trigonometric link terms + noise),
    standardized like the published dataset. Same draws as the JAX package."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, size=(n_pool + n_test, d)).astype(np.float32)

    def response(X):
        # Distance of an articulated 4-link arm endpoint.
        angles = np.cumsum(X[:, :4] * np.pi, axis=1)
        lengths = 0.5 + 0.5 * np.abs(X[:, 4:8])
        ex = np.sum(lengths * np.cos(angles), axis=1)
        ey = np.sum(lengths * np.sin(angles), axis=1)
        return np.sqrt(ex**2 + ey**2).astype(np.float32)

    y = response(X) + 0.05 * rng.standard_normal(n_pool + n_test).astype(np.float32)
    y = (y - y.mean()) / y.std()
    return Kin40k(
        train_x=X[:n_pool],
        train_y=y[:n_pool],
        test_x=X[n_pool:],
        test_y=y[n_pool:],
    )


def load_kin40k(path: Optional[str] = None) -> Kin40k:
    """Load from ``path`` (``.xlsx``, ``.npz`` or directory of csv) or fall
    back to the synthetic stand-in. Env var ``GPSCORE_KIN40K`` overrides."""
    path = path or os.environ.get("GPSCORE_KIN40K")
    if path and os.path.exists(path):
        if path.endswith(".xlsx"):
            # The reference's format (`kin40k-FULL-compare.py:197-200`). pandas
            # where it has an xlsx engine, else the standard-library reader.
            names = ["trainx", "trainy", "testx", "testy"]
            try:
                import pandas as pd

                # One call: read_excel parses the whole workbook every time.
                sheets = pd.read_excel(path, sheet_name=names, header=None)
            except ImportError:
                from gpscore_torch.data.xlsx_lite import read_sheets

                sheets = read_sheets(path, names)
            arr = {k: np.asarray(v, np.float32) for k, v in sheets.items()}
            return Kin40k(
                arr["trainx"], arr["trainy"].reshape(-1), arr["testx"], arr["testy"].reshape(-1)
            )
        if path.endswith(".npz"):
            z = np.load(path)
            return Kin40k(
                np.asarray(z["trainx"], np.float32),
                np.asarray(z["trainy"], np.float32).reshape(-1),
                np.asarray(z["testx"], np.float32),
                np.asarray(z["testy"], np.float32).reshape(-1),
            )
        if os.path.isdir(path):

            def rd(name):
                return np.loadtxt(
                    os.path.join(path, f"{name}.csv"), delimiter=",", dtype=np.float32
                )

            return Kin40k(
                rd("trainx"), rd("trainy").reshape(-1), rd("testx"), rd("testy").reshape(-1)
            )
        raise ValueError(f"unsupported kin40k path: {path}")
    return synthesize_kin40k_like()


_FITC20_INIT = os.path.join(os.path.dirname(__file__), "kin40k_fitc20_init.json")


def kin40k_fitc20_init(device="cpu") -> GPParams:
    """The initial parameters of the KIN40K FITC-20 benchmark: unit log signal
    and noise, log lengths [8] and inducing points [20, 8] as ``bench.py:50-57``
    draws them from ``jax.random.PRNGKey(0)``. The draw is committed as float32
    values, since threefry cannot be replayed without JAX; the tests hold the
    file equal to the JAX draw."""
    with open(_FITC20_INIT) as f:
        arrays = json.load(f)
    return params_from_numpy(arrays, device=device)


def kin40k_replicate_split(
    data: Kin40k,
    replicate: int,
    n_subsample: int = 500,
    n_va: int = 300,
    n_test: int = 500,
    device="cpu",
) -> ReplicateSplit:
    """Per-replicate subsampling (`kin40k-FULL-compare.py:194-214`): seed j*100,
    draw n_subsample+n_va pool rows without replacement, then carve n_va of those
    into validation; first n_test test rows. Tensors land on ``device``."""
    rng = np.random.default_rng(replicate * 100)
    sam = rng.choice(data.train_x.shape[0], size=n_subsample + n_va, replace=False)
    full_x = data.train_x[sam]
    full_y = data.train_y[sam]
    va_idx = rng.choice(full_x.shape[0], size=n_va, replace=False)
    mask = np.ones(full_x.shape[0], dtype=bool)
    mask[va_idx] = False

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return ReplicateSplit(
        train_x=t(full_x[mask]),
        train_y=t(full_y[mask]),
        va_x=t(full_x[va_idx]),
        va_y=t(full_y[va_idx]),
        test_x=t(data.test_x[:n_test]),
        test_y=t(data.test_y[:n_test]),
    )
