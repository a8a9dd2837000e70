"""Precision policy: IEEE fp32 contractions.

The JAX package's default mode "highest" runs every contraction as exact fp32
passes (`gpscore/utils/precision.py:39-42`). On a CUDA card the counterpart is
plain fp32 with TF32 switched off for both cuBLAS matmuls and cuDNN, which
:func:`use_ieee_fp32` sets (the package calls it on import).

The JAX package's reduced modes ("high", "fast", "bf16", "f16") are not ported
yet: selecting one raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

MODES = ("highest", "high", "fast", "bf16", "f16")
_MODE = "highest"


def use_ieee_fp32() -> None:
    """Switch TF32 off everywhere: fp32 matmuls run as IEEE fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def set_matmul_mode(mode: str) -> None:
    """Select the library-wide contraction mode. Only "highest" exists yet."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if mode != _MODE:
        raise NotImplementedError(
            f"matmul mode {mode!r} is not ported yet; only 'highest' (IEEE fp32)"
        )
    use_ieee_fp32()


def get_matmul_mode() -> str:
    return _MODE


def matmul(a, b):
    """fp32 matmul (IEEE fp32: TF32 is off)."""
    return torch.matmul(a, b)


def matmul_crit(a, b):
    """Matmul for cancellation-critical accumulations. In "highest" mode it is
    :func:`matmul`; the distinction matters once reduced modes exist."""
    return torch.matmul(a, b)
