"""FLOP of one exact large-n value-and-grad step.

Copied from ``gpscore_torch/experiments/bench_ceiling.py:79-92`` (``step_flop``):
n^3 for the in-place K_hat^-1 (LAPACK's counts: potrf n^3/3, trtri n^3/3,
lauum n^3/3), plus, for a LOO rule, 2 n^3 for the backward's [b, n] x [n, n]
GEMMs over all row blocks, and for a fold rule 2 n^3 (1 + 1/k): per fold and
row block a [b, nb] x [nb, nb] and a [b, nb] x [nb, n] GEMM (the folds' own
factorizations, O(n^3 / k^2), are left out). The NLML backward has no n^3
term.
"""

FOLD_RULES = ("dss", "kc", "es")


def step_flop(rule: str, n: int, fold_k: int = 4) -> float:
    n3 = float(n) ** 3
    if rule == "nlml":
        return n3
    return n3 * (3.0 + 2.0 / fold_k if rule in FOLD_RULES else 3.0)
