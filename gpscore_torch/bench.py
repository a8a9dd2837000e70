"""Main-path benchmark of the port: the KIN40K FITC-20 fit, all five rules, on
one CUDA card.

    python -m gpscore_torch.bench [--eager [ITERS]] [--histories PATH.npz]

The workload of the JAX package's ``bench.py``: n_train = 500, d = 8, m = 20
trained inducing points, the reference schedules (crps 2000, nlml/logs/dss/kc
3000 iterations each, 14,000 GD iterations in all), from the same initial
parameters (``gpscore_torch/data/kin40k_fitc20_init.json``). One warm-up fit
of 20 iterations per rule runs first (kernel build, cuBLAS/cuSOLVER set-up);
the timed fit is the full schedule, between ``torch.cuda.synchronize()``
calls, with ``fit_gd``'s default on a card: per rule three eager steps, one
step captured in a CUDA graph, and one replay per remaining iteration.

Prints on stderr each rule's final loss, its seconds and its microseconds per
step, and the fit wall-clock; then, per rule, the device ops and the
device-busy time of one *replayed* step (torch.profiler over a short and a
long graphed fit, whose difference is replays alone) and its idle share
against the timed fit's time per step. ``--eager`` also
times the eager loop (``graph=False``) in the same call, capped at ITERS
iterations per rule when given, and prints both and their ratio per step.
Last, one JSON line on stdout:
``{"metric": "kin40k_fitc20_all_rules_fit_wall_clock", "value": ..., "unit": "s",
"backend": "torch-cuda", "device": ...}``. ``--histories`` also saves every
rule's loss history (npz) for comparison with the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gpscore_torch.bench_gram import nvidia_smi_line
from gpscore_torch.data import kin40k_fitc20_init, kin40k_replicate_split, load_kin40k
from gpscore_torch.fit import SCHEDULES, fit_gd, make_objective
from gpscore_torch.fit.train import GRAPH_WARMUP
from gpscore_torch.utils.profiling import device_events

RULES = ["crps", "nlml", "logs", "dss", "kc"]
WARMUP_ITERS = 20
# The profiled fits: both capture, the long one replays PROFILE_STEPS more.
PROFILE_SHORT = GRAPH_WARMUP + 20
PROFILE_STEPS = 200


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fit_all(params, x, y, iters=None, graph=None):
    """Every rule's fit from ``params``; ``iters`` caps the schedules and
    ``graph`` is ``fit_gd``'s. Returns the fits and each rule's seconds
    (synchronized at rule boundaries)."""
    out, seconds = {}, {}
    for rule in RULES:
        sched = SCHEDULES[("kin40k_fitc", rule)]
        t0 = time.perf_counter()
        out[rule] = fit_gd(
            make_objective(rule, model="fitc"), params, x, y,
            iters=sched.iters if iters is None else min(iters, sched.iters),
            lr=sched.lr, lr_inducing=sched.lr_inducing, graph=graph,
        )
        torch.cuda.synchronize()
        seconds[rule] = time.perf_counter() - t0
    return out, seconds


def profile_replayed(fit, short=PROFILE_SHORT, steps=PROFILE_STEPS):
    """One replayed step of the graphed fit ``fit(iters)`` under
    torch.profiler: (device work items, device-busy microseconds). Two fits
    are profiled, of ``short`` and ``short + steps`` iterations; warm-up,
    capture and set-up are in both, so their difference is ``steps`` replays.
    (The host clock's difference is no use: it is the capture's spread.)"""
    from torch.profiler import ProfilerActivity, profile

    fit(short)  # warm
    seen = []
    for iters in (short, short + steps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fit(iters)
            torch.cuda.synchronize()
        dev = device_events(prof)
        seen.append((len(dev), sum(e.time_range.elapsed_us() for e in dev)))
    return tuple((b - a) / steps for a, b in zip(*seen))


def profile_steps(params, x, y, step_us):
    """Per rule, a replayed GD step under torch.profiler: device work items
    (kernels, copies, sets) and device-busy time per step, and the idle share
    against ``step_us[rule]``, the unprofiled timed fit's time per step."""
    for rule in RULES:
        sched = SCHEDULES[("kin40k_fitc", rule)]
        loss = make_objective(rule, model="fitc")
        ops, busy_us = profile_replayed(
            lambda iters: fit_gd(loss, params, x, y, iters, sched.lr, sched.lr_inducing,
                                 graph=True))
        log(f"[profile] {rule}: {ops:.1f} device ops per replayed step, device busy "
            f"{busy_us:.1f} us per step; {step_us[rule]:.1f} us per step in the timed fit: idle "
            f"share {1 - busy_us / step_us[rule]:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--histories", default=None, help="save loss histories to this .npz")
    ap.add_argument("--eager", nargs="?", type=int, const=0, default=None, metavar="ITERS",
                    help="also time the eager loop, at most ITERS iterations per rule "
                         "(default: the whole schedules)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gpscore_torch.bench measures a CUDA card; none is available")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    name = smi.split(",")[0].strip()
    s = kin40k_replicate_split(load_kin40k(), 0, device=dev)
    params0 = kin40k_fitc20_init(dev)

    t0 = time.perf_counter()
    fit_all(params0, s.train_x, s.train_y, iters=WARMUP_ITERS)
    torch.cuda.synchronize()
    log(f"warm-up ({WARMUP_ITERS} iterations per rule, kernel build included): "
        f"{time.perf_counter() - t0:.1f}s")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, seconds = fit_all(params0, s.train_x, s.train_y)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0

    histories = {rule: res.loss_history.cpu().numpy() for rule, res in out.items()}
    step_us = {rule: seconds[rule] / len(histories[rule]) * 1e6 for rule in RULES}
    for rule in RULES:
        log(f"  {rule}: {len(histories[rule])} iters in {seconds[rule]:.3f}s "
            f"({step_us[rule]:.1f} us per step), final loss {histories[rule][-1]:.6f}, "
            f"stall_iters {int(out[rule].stall_iters)}")
    log(f"fit wall-clock: {elapsed:.3f}s on {smi}")
    if args.histories:
        np.savez(args.histories, **histories)
    if args.eager is not None:
        cap = args.eager or None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager, eager_s = fit_all(params0, s.train_x, s.train_y, iters=cap, graph=False)
        torch.cuda.synchronize()
        log(f"eager loop{f', {cap} iterations per rule at most' if cap else ''}: "
            f"{time.perf_counter() - t0:.3f}s")
        for rule in RULES:
            n_eager = len(eager[rule].loss_history)
            eager_us = eager_s[rule] / n_eager * 1e6
            same = torch.equal(eager[rule].loss_history, out[rule].loss_history[:n_eager])
            log(f"  {rule}: eager {eager_us:.1f} us per step over {n_eager} iters, replayed "
                f"{step_us[rule]:.1f} ({eager_us / step_us[rule]:.2f}x); histories "
                f"{'equal bit for bit' if same else 'DIFFER'}")
    profile_steps(params0, s.train_x, s.train_y, step_us)
    print(json.dumps({
        "metric": "kin40k_fitc20_all_rules_fit_wall_clock",
        "value": elapsed,
        "unit": "s",
        "backend": "torch-cuda",
        "device": name,
    }))


if __name__ == "__main__":
    main()
