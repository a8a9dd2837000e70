"""What the drivers share: the program's precision mode, synchronization,
and the comparison numbers."""

from __future__ import annotations

import contextlib
import math


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def program_mode(mode: str):
    """The program's precision mode around a call (``highest`` is its
    default; a control run selects a lower one). ``tf32`` is ``highest``
    with TF32 switched on beneath the program for every fp32 cuBLAS
    product, the switch the program turns off when it is imported."""
    import torch
    from gpscore_torch.utils.precision import matmul_mode

    with matmul_mode("highest" if mode == "tf32" else mode):
        if mode != "tf32":
            yield
            return
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False


def rel_gap(prog: float, ref: float) -> float:
    """|prog - ref| / |ref|; inf where the program's value is not finite."""
    if not math.isfinite(prog):
        return math.inf
    return abs(prog - ref) / max(abs(ref), 1e-300)


def norm_gap(prog_norm: float, ref_norm: float, scale: float) -> float:
    """The gap between two norms over ``scale`` (inf where not finite)."""
    if not math.isfinite(prog_norm):
        return math.inf
    return abs(prog_norm - ref_norm) / max(scale, 1e-300)

