"""The exact GP fitted and evaluated at large n (port of `experiments/large_n.py`).

    python -m gpscore_torch.experiments.large_n --n 30720 --d 8 --n-test 2048 \\
        --rules crps nlml --iters 10 [--block 0] [--eval-chunk 2048] \\
        [--save-params P] [--load-params P] [--skip-eval] [--out F] [--device cuda|cpu]

The reference's dense CPU LOO stops at n = 500 (`kin40k-FULL-compare.py:196`).
From the objectives' threshold on, the exact objectives take the fused cores
(:mod:`gpscore_torch.ops.loo_fused` for crps, logs, interval and nlml,
:mod:`gpscore_torch.ops.fold_stream` for the fold rules dss, es and kc),
whose peak is one n x n buffer, and the evaluation streams test points
through the chunked large-n predictive
(:func:`~gpscore_torch.models.exact.exact_predictive_diag_large`). es draws
its normals from a ``torch.Generator`` on the device, under a fixed seed.

Data: a smooth function of d standard-normal inputs plus noise
(`experiments/large_n.py:51-67`), drawn from a seeded CPU ``torch.Generator``
and then moved, so a CPU and a CUDA run fit the same data; the JAX package's
threefry draws are not replayed. Learning rates: the KIN40K table, times
500/n for the sum-scaled rules (nlml, dss, es), whose reference rates were
tuned at n = 500. Fits are ``fit_gd`` from unit parameters; the JAX
package's ``fit_gd_recovering``, its ``--segment-iters`` chunking and its
reduced-precision options are not ported (only IEEE fp32 exists here).

Each rule prints ``[rule] {json}`` with ``fit_wall_s``, ``s_per_iter_steady``
(the fastest GD step, host clock between device synchronizations), the first
and last loss and the six test metrics.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gpscore_torch.experiments.common import resolve_device, save_results, synchronize
from gpscore_torch.fit import SCHEDULES, Schedule, fit_gd, make_objective
from gpscore_torch.metrics import evaluate_predictive
from gpscore_torch.models.exact import exact_predictive_diag_large
from gpscore_torch.utils.params import (init_unit_params, params_from_checkpoint,
                                        save_params_checkpoint)

RULES = ("crps", "logs", "interval", "nlml", "dss", "es", "kc")
# Sum-scaled objectives, whose reference learning rates (tuned at n = 500)
# are scaled by 500 / n.
SUM_SCALED = ("nlml", "dss", "es")


def make_data(n: int, d: int, n_test: int, seed: int = 0):
    """(x [n, d], y [n], x_test [n_test, d], y_test [n_test]) on the CPU."""
    gen = torch.Generator().manual_seed(seed)

    def f(xx):
        return torch.sin(xx[:, 0]) + 0.5 * torch.cos(2.0 * xx[:, 1 % d]) + 0.3 * xx[:, 2 % d]

    x = torch.randn((n, d), generator=gen)
    y = f(x) + 0.1 * torch.randn((n,), generator=gen)
    xt = torch.randn((n_test, d), generator=gen)
    yt = f(xt) + 0.1 * torch.randn((n_test,), generator=gen)
    return x, y, xt, yt


def schedule_for(rule: str, n: int, iters: int, lr_scale: float = 1.0) -> Schedule:
    """The KIN40K schedule of ``rule`` (kin40k_full, else kin40k_fitc) with
    ``iters`` iterations (0: the reference count) and its lr times
    ``lr_scale``, and times 500/n for a sum-scaled rule."""
    base = SCHEDULES.get(("kin40k_full", rule)) or SCHEDULES[("kin40k_fitc", rule)]
    lr = base.lr * lr_scale
    if rule in SUM_SCALED:
        lr = lr * 500.0 / n
    return Schedule(rule, iters if iters else base.iters, lr)


def _fit(rule, sched, params, x, y, block):
    """fit_gd with a timestamp, after a device synchronization, at the start
    of every step; returns the fit, its wall time and its fastest step. es
    alone draws from the generator, whose seed is fixed."""
    loss = make_objective(rule, model="exact", block=block)
    generator = torch.Generator(device=x.device).manual_seed(1)
    stamps = []

    def timed(p, xx, yy, generator=None):
        synchronize(x.device)
        stamps.append(time.perf_counter())
        return loss(p, xx, yy, generator)

    t0 = time.perf_counter()
    res = fit_gd(timed, params, x, y, sched.iters, sched.lr, generator=generator)
    synchronize(x.device)
    end = time.perf_counter()
    return res, end - t0, float(np.min(np.diff(stamps + [end])))


def _checkpoint(prefix, rule, n_rules):
    """``<prefix>_<rule>.npz`` (the --save-params convention), or the bare
    ``prefix`` when it exists and one rule runs."""
    path = f"{prefix}_{rule}.npz"
    if not os.path.exists(path) and n_rules == 1 and os.path.exists(prefix):
        path = prefix
    if not os.path.exists(path):
        raise FileNotFoundError(f"--load-params: {path} not found (<prefix>_<rule>.npz, as "
                                "--save-params writes; a bare path only with one rule)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30720)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--n-test", type=int, default=2048)
    ap.add_argument("--rules", nargs="+", default=["crps", "nlml"], choices=list(RULES))
    ap.add_argument("--iters", type=int, default=10,
                    help="GD iterations per rule (0: the reference count)")
    ap.add_argument("--lr-scale", type=float, default=1.0)
    ap.add_argument("--block", type=int, default=0,
                    help="panel width of the fused cores and the evaluation (0: auto_block)")
    ap.add_argument("--eval-chunk", type=int, default=2048,
                    help="test points per chunk of the streamed predictive")
    ap.add_argument("--save-params", default=None,
                    help="write each rule's fitted parameters to <prefix>_<rule>.npz")
    ap.add_argument("--load-params", default=None,
                    help="skip the fits: evaluate parameters written by --save-params")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.n % 4 and any(r in ("dss", "es", "kc") for r in args.rules):
        ap.error("fold rules need --n divisible by 4")

    device = resolve_device(args.device)
    x, y, xt, yt = (t.to(device) for t in make_data(args.n, args.d, args.n_test))
    block = args.block or None
    results = {}
    for rule in args.rules:
        if args.load_params:
            path = _checkpoint(args.load_params, rule, len(args.rules))
            p = params_from_checkpoint(path)
            params = p.replace(**{f: t.to(device) for f, t in p.leaves().items()})
            rec = {"n": args.n, "rule": rule, "loaded": path}
        else:
            sched = schedule_for(rule, args.n, args.iters, args.lr_scale)
            res, wall, steady = _fit(rule, sched, init_unit_params(args.d, isotropic=False,
                                                                   device=device), x, y, block)
            params = res.params
            losses = res.loss_history.cpu().tolist()
            rec = {"n": args.n, "rule": rule, "iters": sched.iters, "lr": sched.lr,
                   "fit_wall_s": wall, "s_per_iter_steady": steady,
                   "loss_first": losses[0], "loss_last": losses[-1],
                   "stall_iters": int(res.stall_iters)}
            if args.save_params:
                save_params_checkpoint(f"{args.save_params}_{rule}.npz", params)
        if not args.skip_eval:
            t0 = time.perf_counter()
            pred = exact_predictive_diag_large(x, y, xt, params, block=block,
                                               chunk=args.eval_chunk)
            metrics = evaluate_predictive(pred.mean, pred.cov, yt, y)
            rec.update({k: float(v) for k, v in metrics._asdict().items()})
            rec["eval_s"] = time.perf_counter() - t0
        results[rule] = rec
        print(f"[{rule}] {json.dumps(rec, sort_keys=True)}", flush=True)
    save_results(results, args.out)
    return results


if __name__ == "__main__":
    main()
