"""Main-path benchmark of the port: the KIN40K FITC-20 fit, all five rules, on
one CUDA card.

    python -m gpscore_torch.bench [--histories PATH.npz]

The workload of the JAX package's ``bench.py``: n_train = 500, d = 8, m = 20
trained inducing points, the reference schedules (crps 2000, nlml/logs/dss/kc
3000 iterations each, 14,000 GD iterations in all), from the same initial
parameters (``gpscore_torch/data/kin40k_fitc20_init.json``). One warm-up fit
of 20 iterations per rule runs first (kernel build, cuBLAS/cuSOLVER set-up);
the timed fit is the full schedule, between ``torch.cuda.synchronize()`` calls.

Prints each rule's final loss and the fit wall-clock on stderr, then, from a
separate profiled run of 20 steps per rule, the device ops, device-busy time
and idle share per step (torch.profiler), then one JSON line on stdout:
``{"metric": "kin40k_fitc20_all_rules_fit_wall_clock", "value": ..., "unit": "s",
"backend": "torch-cuda", "device": ...}``. ``--histories`` also saves every
rule's loss history (npz) for comparison with the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from gpscore_torch.data import kin40k_fitc20_init, kin40k_replicate_split, load_kin40k
from gpscore_torch.fit import SCHEDULES, fit_gd, make_objective

RULES = ["crps", "nlml", "logs", "dss", "kc"]
WARMUP_ITERS = 20
PROFILE_STEPS = 20


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fit_all(params, x, y, iters=None):
    """Every rule's fit from ``params``; ``iters`` caps the schedules.
    Returns the fits and each rule's seconds (synchronized at rule boundaries)."""
    out, seconds = {}, {}
    for rule in RULES:
        sched = SCHEDULES[("kin40k_fitc", rule)]
        t0 = time.perf_counter()
        out[rule] = fit_gd(
            make_objective(rule, model="fitc"), params, x, y,
            iters=sched.iters if iters is None else min(iters, sched.iters),
            lr=sched.lr, lr_inducing=sched.lr_inducing,
        )
        torch.cuda.synchronize()
        seconds[rule] = time.perf_counter() - t0
    return out, seconds


def profile_steps(params, x, y, steps, step_us):
    """Per rule, ``steps`` GD iterations under torch.profiler: device work
    items (kernels, copies, sets) per step and device-busy time per step. The
    idle share is given against the wall time per step of the profiled run
    and against ``step_us[rule]``, the unprofiled timed fit's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for rule in RULES:
        sched = SCHEDULES[("kin40k_fitc", rule)]
        loss = make_objective(rule, model="fitc")
        fit_gd(loss, params, x, y, 3, sched.lr, sched.lr_inducing)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fit_gd(loss, params, x, y, steps, sched.lr, sched.lr_inducing)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in dev)
        log(f"[profile] {rule}: {len(dev) / steps:.1f} device ops per step, device busy "
            f"{busy_us / steps:.1f} us per step; wall {wall_us / steps:.1f} us per step "
            f"under the profiler (idle share {1 - busy_us / wall_us:.3f}), "
            f"{step_us[rule]:.1f} us in the timed fit (idle share "
            f"{1 - busy_us / steps / step_us[rule]:.3f})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--histories", default=None, help="save loss histories to this .npz")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gpscore_torch.bench measures a CUDA card; none is available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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
    profile_steps(params0, s.train_x, s.train_y, PROFILE_STEPS, step_us)
    print(json.dumps({
        "metric": "kin40k_fitc20_all_rules_fit_wall_clock",
        "value": elapsed,
        "unit": "s",
        "backend": "torch-cuda",
        "device": name,
    }))


if __name__ == "__main__":
    main()
