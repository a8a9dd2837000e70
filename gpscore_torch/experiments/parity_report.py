"""Measured numerical parity against the fp64 NumPy/SciPy oracle (port of
`experiments/parity_report.py`).

The same problem (n = 120, 64 test points, d = 3, numpy seed 0), the same
quantities and targets as the JAX driver: the ARD Gram, the exact
predictive's mean and covariance, the LOO mean and variance, CRPS, log
score, DSS and NLML, each against ``tests/oracle.py`` (an independent fp64
implementation of the reference formulas, part of neither package), as
maximum absolute errors (relative for DSS and NLML) in one JSON report.

- ``--dtype float32`` (default): the fp32 targets (posterior moments 5e-4 /
  5e-5, scores 1e-4, the Gram 5e-6), on ``--device`` (default cuda), the
  Gram through its kernel.
- ``--dtype float64``: every target 5e-9 (fp64 summation-order noise), which
  proves the formulas are the reference's. The Gram kernels take float32
  only, so float64 runs with ``--device cpu`` (the plain versions); on a
  card it raises.

    python -m gpscore_torch.experiments.parity_report [--out parity.json]
        [--dtype float64 --device cpu]

Exit code 0 when every target passes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

from gpscore_torch.experiments.common import resolve_device
from gpscore_torch.models.exact import exact_predictive, loo_exact, nlml_exact
from gpscore_torch.ops.kernels import gram
from gpscore_torch.scoring.rules import crps_gaussian, dss, logs_gaussian

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_oracle():
    """``tests/oracle.py`` of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location("oracle", os.path.join(_ROOT, "tests",
                                                                         "oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    return oracle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.dtype == "float64" and device.type == "cuda":
        raise ValueError("--dtype float64 on a CUDA device: the Gram kernels take float32 only "
                         "(gpscore_torch/ops/gram_cuda.py::_check); run float64 with "
                         "--device cpu, where the plain versions compute the Gram")
    oracle = load_oracle()
    dt = np.dtype(args.dtype)

    rng = np.random.default_rng(0)
    n, t, d = args.n, 64, 3
    x = rng.standard_normal((n, d)).astype(dt)
    xs = rng.standard_normal((t, d)).astype(dt)
    y = rng.standard_normal(n).astype(dt)
    a = 0.2
    ll = (0.3 * rng.standard_normal(d)).astype(dt)
    noise_sq = 0.09

    def T(v):
        return torch.as_tensor(v, device=device)

    K = gram(T(x), T(x), a, T(ll))
    Ksf = gram(T(xs), T(x), a, T(ll))
    Kss = gram(T(xs), T(xs), a, T(ll))

    K64 = oracle.ard_gram(x, x, a, ll)
    Ksf64 = oracle.ard_gram(xs, x, a, ll)
    Kss64 = oracle.ard_gram(xs, xs, a, ll)

    report = {}
    fp64 = args.dtype == "float64"

    def rec(name, got, want, target32, relative=False):
        got = got.detach().cpu().numpy().astype(np.float64)
        err = float(np.max(np.abs(got - np.asarray(want))))
        kind = "max_abs_err"
        if relative:
            err = err / max(float(np.max(np.abs(np.asarray(want)))), 1e-30)
            kind = "max_rel_err"
        target = 5e-9 if fp64 else target32  # 5e-9: fp64 summation-order noise
        report[name] = {kind: err, "target": target, "pass": err <= target}

    with torch.no_grad():
        rec("gram", K, K64, 5e-6)

        pred = exact_predictive(Ksf, K, Kss, T(y), noise_sq)
        mean64, cov64 = oracle.exact_predictive(Ksf64, K64, Kss64, y, noise_sq)
        rec("posterior_mean", pred.mean, mean64, 5e-4)
        rec("posterior_cov", pred.cov, cov64, 5e-5)

        loo = loo_exact(K, T(y), noise_sq)
        lm64, lv64 = oracle.loo_identity(K64, y, noise_sq)
        rec("loo_mean", loo.mean, lm64, 5e-4)
        rec("loo_var", loo.cov, lv64, 5e-5)

        m = rng.standard_normal(n).astype(dt)
        v = (0.5 + rng.random(n)).astype(dt)
        rec("crps", crps_gaussian(T(m), T(v), T(y)), oracle.crps_gaussian(m, v, y), 1e-4)
        rec("logs", logs_gaussian(T(m), T(v), T(y)), oracle.logs_gaussian(m, v, y), 1e-4)
        C = (np.asarray(oracle.ard_gram(x[:16], x[:16], 0.0, ll), dt)
             + np.asarray(0.5 * np.eye(16), dt))
        rec("dss", dss(T(m[:16]), T(C), T(y[:16])), oracle.dss(m[:16], C, y[:16]), 1e-4,
            relative=True)
        rec("nlml", nlml_exact(K, T(y), noise_sq), oracle.nlml(K64, y, noise_sq), 1e-4,
            relative=True)

    out = json.dumps(report, indent=2, sort_keys=True)
    print(out)
    overall = all(r["pass"] for r in report.values())
    print(f"# overall: {'PASS' if overall else 'FAIL'}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    return 0 if overall else 1


if __name__ == "__main__":
    raise SystemExit(main())
