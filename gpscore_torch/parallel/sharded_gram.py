"""Row-sharded Gram construction over the 'data' mesh axis (port of
`gpscore/parallel/sharded_gram.py`).

Each rank holds x_local [n/p, d], gathers the raw design matrix over 'data'
(n d elements, one all-gather), and computes only its own block of rows,
K(x_local, x) [n/p, n], through the Gram kernels (``ArdGram``: the forward
kernel, and in the backward the row and column kernels on the local rows).
JAX calls the jnp Gram here (`sharded_gram.py:19`), since GSPMD cannot
partition the Pallas custom call; the port's kernels run per rank, so the
sharded Gram is the kernel's.

Gradients: ``ArdGram``'s backward gives each rank the parameter gradient of
its own rows, a partial sum; the sharded steps all-reduce those over 'data'.
The all-gather is not differentiated, so no gradient reaches x, as none
reaches a training input in a fit.
"""

from __future__ import annotations

from gpscore_torch.ops.kernels import gram
from gpscore_torch.parallel.mesh import Mesh, gather_rows


def sharded_gram(x, log_signal_sq, log_length, mesh: Mesh, axis: str = "data", *,
                 kind: str = "ard"):
    """This rank's rows of the symmetric Gram K(x, x): x is this rank's row
    block [n/p, d] (n divides by the axis size); returns K [n/p, n], the
    rows of K whose indices x's rows carry. ``kind`` as in
    :func:`gpscore_torch.ops.kernels.gram` ("rbf": one log squared length)."""
    x_full = gather_rows(x, mesh, axis)  # [n, d]
    return gram(x.contiguous(), x_full, log_signal_sq, log_length, kind=kind)
