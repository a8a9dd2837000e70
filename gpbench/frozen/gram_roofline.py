"""Operations and bytes of one Gram kernel call, and its roofline bound.

Copied from ``gpscore_torch/ops/gram_cuda.py:119-161`` (``Roofline``,
``roofline``), with the peaks of :mod:`gpbench.frozen.peaks`. Counts:

- bytes: xs [n, d], xps [m, d] and sig are read by all three kernels; the
  backward halves also read the cotangent g [n, m]; outputs are K [n, m]
  (forward; ``out_bytes`` an element; ``diag`` reads the diagonal's scalar
  too), d_xs [n, d] and rowsum [n] (rows half), d_xps [m, d] (columns half).
  ``shared_x``: K(x, x), x read once.
- operations per element of K: 3d + 3 forward (d differences, d FMAs, the
  scale, the exp, sig), 6d + 6 for either backward half.
- ``batch`` Grams in one call multiply both.

The bound is the larger of bytes / bandwidth and operations / peak.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from gpbench.frozen.peaks import H100_BYTES_PER_S, H100_FP32_FLOP_PER_S, H100_FP64_FLOP_PER_S

KERNELS = ("gram_fwd", "gram_fwd_dchunk", "gram_bwd_rows", "gram_bwd_cols")


class Roofline(NamedTuple):
    bytes: int
    flops: int
    bound_us: float
    bound_by: str  # "bytes" or "operations"


def roofline(kernel: str, n: int, m: int, d: int, out_bytes: Optional[int] = None,
             diag: bool = False, batch: int = 1, shared_x: bool = False,
             elem: int = 4) -> Roofline:
    """The roofline bound of one call of ``kernel`` at K of n x m on d inputs."""
    out_bytes = elem if out_bytes is None else out_bytes
    if shared_x and n != m:
        raise ValueError(f"shared_x needs a square K, not {n} x {m}")
    inputs = n * d + (0 if shared_x else m * d) + 1
    out = 0
    if kernel in ("gram_fwd", "gram_fwd_dchunk"):
        floats, flops = inputs + int(diag), (3 * d + 3) * n * m
        out = out_bytes * n * m
    elif kernel == "gram_bwd_rows":
        floats, flops = inputs + n * m + n * d + n, (6 * d + 6) * n * m
    elif kernel == "gram_bwd_cols":
        floats, flops = inputs + n * m + m * d, (6 * d + 6) * n * m
    else:
        raise ValueError(f"no roofline for kernel {kernel!r}")
    nbytes, flops = batch * (elem * floats + out), batch * flops
    peak = H100_FP64_FLOP_PER_S if elem == 8 else H100_FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return Roofline(nbytes, flops, max(t_bytes, t_ops) * 1e6,
                    "bytes" if t_bytes >= t_ops else "operations")

