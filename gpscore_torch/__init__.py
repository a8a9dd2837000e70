"""gpscore_torch: scoring-rule inference for Gaussian-process regression in PyTorch.

The PyTorch/CUDA counterpart of :mod:`gpscore` (the JAX reference, which stays
in the repository unchanged). Module names mirror ``gpscore/``:

- ``gpscore_torch.ops``      — Gram construction (the ARD Gram forward and
                               backward are hand-written CUDA C++ kernels on a
                               CUDA tensor), Cholesky-based linear algebra,
                               the in-place K_hat^-1 pipeline and the fused
                               large-n LOO/k-fold/NLML cores.
- ``gpscore_torch.models``   — the exact GP and the FITC posterior (Woodbury
                               form).
- ``gpscore_torch.scoring``  — CRPS, log score, energy score, k-fold CRPS,
                               interval score.
- ``gpscore_torch.fit``      — objectives, full-batch gradient descent (on a
                               card one CUDA graph replayed per iteration),
                               an opt-in ``torch.optim`` loop, schedules,
                               fit-and-evaluate.
- ``gpscore_torch.metrics``  — MSE/SMSE/MSLL/coverage evaluation suite.
- ``gpscore_torch.data``     — KIN40K loader (xlsx, npz, csv) and replicate
                               protocol.
- ``gpscore_torch.analysis`` — objective surfaces, scoring-rule sensitivity
                               curves, the CRPS illustration and their plots.
- ``gpscore_torch.utils``    — parameters, pytree checkpoints, precision mode,
                               timing and tracing.

Importing the package pins IEEE fp32 contractions (TF32 off), the JAX
package's default "highest" precision mode (:mod:`gpscore_torch.utils.precision`).
It imports neither ``jax``, ``gpscore`` nor ``triton``.
"""

from gpscore_torch.utils import precision as _precision

_precision.use_ieee_fp32()

from gpscore_torch import analysis, data, fit, metrics, models, ops, scoring, utils  # noqa: E402

__version__ = "0.1.0"

__all__ = ["analysis", "data", "fit", "metrics", "models", "ops", "scoring", "utils"]
