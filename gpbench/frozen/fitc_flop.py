"""FLOP of one FITC value-and-grad step, counted from n, m, d and the fold
count: the work of the math in ``gpscore_torch/models/fitc.py:44-63``
(``fitc_terms``) and ``:167-207`` (the k-fold forms), whatever implements it.

Per restart and step, forward:

- Grams K(x, u) [n, m] and K(u, u) [m, m]: (3d + 3) FLOP an element (the
  count of :mod:`gpbench.frozen.gram_roofline`);
- two m x m Choleskys (L_uu, L_M): m^3 / 3 each;
- V = L_uu^-1 K(u, x): n m^2; M = I + V^T (V / g): 2 n m^2;
  W = L_M^-1 (V / g)^T: n m^2; q_ff, g, V / g and the B^-1 diagonal: 6 n m;
- the LOO and NLML rules: B^-1 y through W, 4 n m;
- the fold rules (dss, kc): B^-1 y (4 n m), per fold M_f = I - W_f^T G W_f
  (2 n m^2 over the folds), its Cholesky (k m^3 / 3) and the mean's solves
  (4 n m); kc also the fold variances' triangular solve (n m^2 + 2 n m).

Backward: the Gram backward's two halves, (6d + 6) FLOP an element of each
K for each half; the linear algebra's backward at twice its forward. So a
step is Grams (3d + 3 + 2 (6d + 6)) (n m + m^2) plus three times the
forward's linear algebra. O(n) and O(m) terms are left out.
"""


def fitc_step_flop(rule: str, n: int, m: int, d: int, fold_k: int = 4) -> float:
    gram_elems = n * m + m * m
    grams = (3 * d + 3 + 2 * (6 * d + 6)) * gram_elems
    la = 2 * m ** 3 / 3 + 4 * n * m * m + 6 * n * m
    if rule in ("dss", "kc"):
        la += 4 * n * m + 2 * n * m * m + fold_k * m ** 3 / 3 + 4 * n * m
        if rule == "kc":
            la += n * m * m + 2 * n * m
    else:
        la += 4 * n * m
    return float(grams + 3 * la)
