"""The exact GP's large-n step at a wide input on one CUDA card.

    python -m gpscore_torch.experiments.bench_wide                 # n = 30,720, d = 90
    python -m gpscore_torch.experiments.bench_wide --n 8192 --rules crps --out t.json

For each rule (crps: the fused LOO core; dss: the fold-streamed k-fold
core), one value-and-grad step of the exact objective at large_n's data
(``large_n.make_data``, seed 0) and unit parameters, the log lengths raised
by log(d / 8) / 2 so that the squared distances are the d = 8 case's (at
unit lengths and d = 90 they are ~180 and K is the identity to fp32): the
wall seconds of the step (the fastest of ``--repeats``), the allocator's
peak over it in n^2 * 4 bytes, and, from one more step under
torch.profiler, its device seconds by kind of kernel and the Gram backward
kernels' milliseconds (``gram_bwd_ms``) and launches. One JSON line per
rule, then the card's ``nvidia-smi`` name and power limit.

It uses only entry points that the port has had since its large-n cores
(``make_objective``, ``bench_ceiling.value_and_grad`` and
``device_profile``, ``large_n.make_data``), so the same file can time an
older checkout's kernels: copy it into that checkout's
``gpscore_torch/experiments/`` and run it from there.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from gpscore_torch.experiments import bench_ceiling, large_n
from gpscore_torch.fit import make_objective
from gpscore_torch.utils.params import init_unit_params


def wide_params(d: int, device):
    """Unit parameters with the log lengths raised by log(d / 8) / 2."""
    p = init_unit_params(d, isotropic=False, device=device)
    return p.replace(log_length=p.log_length + 0.5 * math.log(d / 8.0))


def gram_bwd(top):
    """(milliseconds, kernels) of the Gram backward's kernels in a
    :func:`bench_ceiling.device_profile` list of (name, seconds)."""
    rows = [(name, sec) for name, sec in top if "gram_bwd" in name]
    return sum(sec for _, sec in rows) * 1e3, len(rows)


def measure(rule: str, x, y, params, repeats: int = 2) -> dict:
    """The step of ``rule``'s exact objective at (x, y, params): wall
    seconds (the fastest of ``repeats``), peak in n^2 * 4 bytes, device
    seconds by kind, the Gram backward's ms."""
    n = x.shape[0]
    loss = make_objective(rule, model="exact")
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bench_ceiling.value_and_grad(loss, params, x, y)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    busy, kinds, top, _ = bench_ceiling.device_profile(
        lambda: bench_ceiling.value_and_grad(loss, params, x, y))
    bwd_ms, bwd_names = gram_bwd(top)
    return {"rule": rule, "n": n, "d": x.shape[1], "step_s": min(walls),
            "peak_n2": peak / (4.0 * n * n), "busy_s": busy,
            "ms_by_kind": {k: v * 1e3 for k, v in kinds.items()},
            "gram_bwd_ms": bwd_ms, "gram_bwd_kernel_names": bwd_names}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30720)
    ap.add_argument("--d", type=int, default=90)
    ap.add_argument("--rules", nargs="+", default=["crps", "dss"])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_wide: torch.cuda.is_available() is false; needs a CUDA card")
    dev = torch.device("cuda", 0)
    x, y, _, _ = (t.to(dev) for t in large_n.make_data(args.n, args.d, 0))
    params = wide_params(args.d, dev)
    out = []
    for rule in args.rules:
        rec = measure(rule, x, y, params, args.repeats)
        rec["device"] = torch.cuda.get_device_name(0)
        out.append(rec)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    from gpscore_torch.bench_gram import nvidia_smi_line
    print(nvidia_smi_line())
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
