"""One exact objective's value-and-grad at large n, measured (port of
`experiments/bench_ceiling.py`, minimal).

    python -m gpscore_torch.experiments.bench_ceiling --n 65536 --rule crps [--block 0]

The step is ``make_objective(rule, model="exact")``'s: the fused cores from
n = 8192 on, the dense path below. Prints one JSON line on a CUDA card:

- ``step_s``: the fastest of ``--repeats`` steps (host clock between device
  synchronizations), after one warm-up step (``warmup_s``);
- ``peak_n2``: ``torch.cuda.max_memory_allocated()`` over one step after
  ``reset_peak_memory_stats()``, in units of n^2 * 4 bytes (``peak_bytes``);
- ``busy_s`` and ``idle_share``: device time of one profiled step, summed
  over torch.profiler's CUDA events, and the share of that step's wall time
  the card is idle;
  ``busy_by_kind``: that time by kind of kernel (:func:`kernel_kind`);
- ``tflops``: the step's FLOP (:func:`step_flop`) over ``step_s``;
- the card's ``nvidia-smi`` name and power limit.

With ``--device cpu`` the device fields are null.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gpscore_torch.bench_gram import nvidia_smi_line
from gpscore_torch.experiments.common import resolve_device, synchronize
from gpscore_torch.fit import make_objective
from gpscore_torch.ops.loo_fused import auto_block
from gpscore_torch.utils.params import GPParams

RULES = ("crps", "logs", "interval", "nlml")


def make_data(n: int, d: int, seed: int = 0):
    """x [n, d] standard normal, y = sin(sum x) + 0.1 noise, on the CPU
    (`experiments/bench_ceiling.py:43-47`, from a torch.Generator)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=gen)
    return x, torch.sin(x.sum(dim=1)) + 0.1 * torch.randn((n,), generator=gen)


def step_flop(rule: str, n: int) -> float:
    """FLOP of one value-and-grad step: n^3 for the in-place K_hat^-1
    (LAPACK's counts: potrf n^3/3, trtri n^3/3, lauum n^3/3), plus, for a LOO
    rule, 2 n^3 for the backward's [b, n] x [n, n] GEMMs over all row blocks.
    The NLML backward has no n^3 term."""
    return float(n) ** 3 * (1.0 if rule == "nlml" else 3.0)


def value_and_grad(loss, params, x, y):
    leaves = {f: t.detach().clone().requires_grad_() for f, t in params.leaves().items()}
    value = loss(params.replace(**leaves), x, y)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


# Kinds of device kernel by a substring of the name, first match wins.
KERNEL_KINDS = (("gram", ("gram_",)),
                ("solver", ("potrf", "potf2", "getrf", "trsm", "trsv", "trtri", "syrk",
                            "chol")),
                ("gemm", ("gemm", "gemv", "xmma", "cutlass")))


def kernel_kind(name: str) -> str:
    """"gram", "solver" (Cholesky and triangular solves), "gemm" or "other"."""
    low = name.lower()
    return next((kind for kind, keys in KERNEL_KINDS if any(k in low for k in keys)), "other")


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: (device seconds summed over
    its CUDA events, {kind: seconds}, [(kernel name, seconds)] largest
    first, the call's host-clock seconds between device synchronizations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    by_kind = {kind: 0.0 for kind, _ in KERNEL_KINDS + (("other", ()),)}
    for name, sec in by_name.items():
        by_kind[kernel_kind(name)] += sec
    return (sum(by_name.values()), by_kind, sorted(by_name.items(), key=lambda kv: -kv[1]),
            wall)


def measure_step(loss, params, x, y):
    """One value-and-grad step on the card: ``peak_bytes``, the allocator's
    peak over the step after ``reset_peak_memory_stats`` (what was allocated
    before it included), and, from a second, profiled step, ``busy_s``,
    ``busy_by_kind`` and ``idle_share``, the share of that step's wall time
    in which the card ran nothing (:func:`device_profile`)."""
    dev = x.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    value_and_grad(loss, params, x, y)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    busy, by_kind, _, wall = device_profile(lambda: value_and_grad(loss, params, x, y))
    return {"peak_bytes": peak, "busy_s": busy, "busy_by_kind": by_kind,
            "idle_share": 1.0 - busy / wall}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30720)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--block", type=int, default=0,
                    help="panel width of the fused cores (0: auto_block)")
    ap.add_argument("--rule", default="crps", choices=list(RULES))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    x, y = (t.to(device) for t in make_data(args.n, args.d))
    block = args.block or auto_block(args.n, device=device)
    loss = make_objective(args.rule, model="exact", block=block)

    def params(i):
        return GPParams(torch.tensor(0.001 * i, device=device),
                        torch.full((args.d,), 0.001 * i, device=device),
                        torch.tensor(-1.0 - 0.001 * i, device=device))

    rec = {"rule": args.rule, "n": args.n, "d": args.d, "block": block}
    t0 = time.perf_counter()
    value, _ = value_and_grad(loss, params(0), x, y)
    synchronize(device)
    rec["warmup_s"] = time.perf_counter() - t0
    rec["loss"] = float(value)
    times = []
    for i in range(1, args.repeats + 1):
        t0 = time.perf_counter()
        value_and_grad(loss, params(i), x, y)
        synchronize(device)
        times.append(time.perf_counter() - t0)
    rec["step_s"] = min(times)
    rec["flop"] = step_flop(args.rule, args.n)
    if device.type == "cuda":
        m = measure_step(loss, params(0), x, y)
        rec.update(m, peak_n2=m["peak_bytes"] / (4.0 * args.n ** 2),
                   tflops=rec["flop"] / rec["step_s"] / 1e12,
                   device=torch.cuda.get_device_name(device), nvidia_smi=nvidia_smi_line())
    else:
        rec.update(peak_bytes=None, peak_n2=None, busy_s=None, busy_by_kind=None,
                   idle_share=None, tflops=None, device="cpu")
    print(json.dumps(rec, sort_keys=True), flush=True)
    return rec


if __name__ == "__main__":
    main()
