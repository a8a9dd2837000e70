from gpscore_torch.ops.gram_cuda import LAUNCHES, ArdGram, reset_launches
from gpscore_torch.ops.kernels import ard_gram, gram, kernel_diag, rbf_gram
from gpscore_torch.ops.linalg import (
    chol_factor,
    chol_solve,
    chol_solve_from_factor,
    half_logdet,
    inv_diag_from_chol,
    safe_cholesky,
    tri_solve,
)

__all__ = [
    "LAUNCHES",
    "ArdGram",
    "reset_launches",
    "ard_gram",
    "gram",
    "kernel_diag",
    "rbf_gram",
    "chol_factor",
    "chol_solve",
    "chol_solve_from_factor",
    "half_logdet",
    "inv_diag_from_chol",
    "safe_cholesky",
    "tri_solve",
]
