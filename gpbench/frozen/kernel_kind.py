"""Kinds of device kernel by a substring of the name, first match wins.

Copied from ``gpscore_torch/experiments/bench_ceiling.py:127-139``
(``KERNEL_KINDS``, ``kernel_kind``).
"""

KERNEL_KINDS = (("collective", ("nccl",)),
                ("gram", ("gram_",)),
                ("solver", ("potrf", "potf2", "getrf", "trsm", "trsv", "trtri", "syrk",
                            "chol")),
                ("gemm", ("gemm", "gemv", "xmma", "cutlass", "nvjet")))
KINDS = tuple(kind for kind, _ in KERNEL_KINDS) + ("other",)


def kernel_kind(name: str) -> str:
    """"collective" (NCCL), "gram", "solver" (Cholesky and triangular
    solves), "gemm" or "other"."""
    low = name.lower()
    return next((kind for kind, keys in KERNEL_KINDS if any(k in low for k in keys)), "other")
