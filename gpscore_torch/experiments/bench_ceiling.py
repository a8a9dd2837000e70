"""One exact objective's value-and-grad at large n, measured (port of
`experiments/bench_ceiling.py`, minimal).

    python -m gpscore_torch.experiments.bench_ceiling --n 65536 --rule crps [--block 0] \\
        [--matmul highest|high|fast|bf16|f16]
    python -m gpscore_torch.experiments.bench_ceiling --crossover 2048 4096 8192
    python -m gpscore_torch.experiments.bench_ceiling --ceiling 98304 8192 --rule crps --matmul high

The step is ``make_objective(rule, model="exact")``'s: the fused cores from
the objectives' threshold on, the dense path below; es draws from a seeded
generator on the device. Prints one JSON line on a CUDA card:

- ``step_s``: the fastest of ``--repeats`` steps (host clock between device
  synchronizations), after one warm-up step (``warmup_s``);
- ``peak_n2``: ``torch.cuda.max_memory_allocated()`` over one step after
  ``reset_peak_memory_stats()``, in units of n^2 * 4 bytes (``peak_bytes``);
- ``busy_s`` and ``idle_share``: device time of one profiled step, summed
  over torch.profiler's CUDA events, and the share of that step's wall time
  the card is idle;
  ``busy_by_kind``: that time by kind of kernel (:func:`kernel_kind`);
- ``tflops``: the step's FLOP (:func:`step_flop`, the "highest" count in
  every mode, so that the modes compare) over ``step_s``;
- the card's ``nvidia-smi`` name and power limit.

The step runs under ``--matmul`` (:mod:`gpscore_torch.utils.precision`).
``--ref-grad`` re-runs the warm-up step (its parameters, its es normals)
under "highest" and adds its accuracy against that run
(`experiments/bench_ceiling.py:153-165`): ``value_rel_err``, the relative
error of the value; ``grad_max_rel``, the largest gradient error relative to
the largest reference gradient entry, over all leaves flattened together;
``grad_cos``, the cosine of the two flattened gradients. Under "highest"
itself they read 0, 0 and 1.

With ``--device cpu`` the device fields are null.

``--crossover`` instead times the dense and the fused step of crps and dss
at each given n (:func:`crossover`) and prints one JSON line per n, rule and
path: the table the objectives' threshold ``_FUSED_LOO_MIN_N`` is set from.

``--ceiling FROM STEP`` takes one value-and-grad of ``--rule`` at n = FROM,
FROM + STEP, ... under ``--matmul`` (:func:`ceiling`), one JSON line each,
until the card runs out of memory or a step takes longer than
``CEILING_MAX_S``; the last line names the largest n that fitted: the
fp32-storage ceilings of ``fit.train._FP32_STORAGE_CEILING_N`` come from it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from gpscore_torch.bench_gram import nvidia_smi_line
from gpscore_torch.experiments.common import resolve_device, synchronize
from gpscore_torch.fit import make_objective, objectives
from gpscore_torch.ops.loo_fused import auto_block
from gpscore_torch.utils.params import GPParams
from gpscore_torch.utils.precision import MODES, matmul_mode
from gpscore_torch.utils.profiling import device_events

RULES = ("crps", "logs", "interval", "nlml", "dss", "kc", "es")
FOLD_RULES = ("dss", "kc", "es")
# The --ceiling search stops after a step this long (seconds): a few minutes
# of chip time per size at most.
CEILING_MAX_S = 180.0


def make_data(n: int, d: int, seed: int = 0):
    """x [n, d] standard normal, y = sin(sum x) + 0.1 noise, on the CPU
    (`experiments/bench_ceiling.py:43-47`, from a torch.Generator)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=gen)
    return x, torch.sin(x.sum(dim=1)) + 0.1 * torch.randn((n,), generator=gen)


def step_flop(rule: str, n: int, fold_k: int = 4) -> float:
    """FLOP of one value-and-grad step: n^3 for the in-place K_hat^-1
    (LAPACK's counts: potrf n^3/3, trtri n^3/3, lauum n^3/3), plus, for a LOO
    rule, 2 n^3 for the backward's [b, n] x [n, n] GEMMs over all row blocks,
    and for a fold rule 2 n^3 (1 + 1/k): per fold and row block a
    [b, nb] x [nb, nb] and a [b, nb] x [nb, n] GEMM (the folds' own
    factorizations, O(n^3 / k^2), are left out). The NLML backward has no
    n^3 term. The count is that of full rows: the backward streams the lower
    block-triangle (``ops/loo_fused.py``), so its second GEMM executes
    ~n^3 (1 + b/n) of the 2 n^3 counted."""
    n3 = float(n) ** 3
    if rule == "nlml":
        return n3
    return n3 * (3.0 + 2.0 / fold_k if rule in FOLD_RULES else 3.0)


@contextlib.contextmanager
def fused_from(n):
    """Inside the block the exact objectives take the fused large-n cores
    from ``n`` on (``objectives._FUSED_LOO_MIN_N``)."""
    saved = objectives._FUSED_LOO_MIN_N
    objectives._FUSED_LOO_MIN_N = n
    try:
        yield
    finally:
        objectives._FUSED_LOO_MIN_N = saved


def value_and_grad(loss, params, x, y, **kw):
    """(value, {leaf: gradient}) of ``loss(params, x, y, **kw)``."""
    leaves = {f: t.detach().clone().requires_grad_() for f, t in params.leaves().items()}
    value = loss(params.replace(**leaves), x, y, **kw)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


# Kinds of device kernel by a substring of the name, first match wins.
KERNEL_KINDS = (("collective", ("nccl",)),
                ("gram", ("gram_",)),
                ("solver", ("potrf", "potf2", "getrf", "trsm", "trsv", "trtri", "syrk",
                            "chol")),
                ("gemm", ("gemm", "gemv", "xmma", "cutlass", "nvjet")))


def kernel_kind(name: str) -> str:
    """"collective" (NCCL), "gram", "solver" (Cholesky and triangular
    solves), "gemm" or "other"."""
    low = name.lower()
    return next((kind for kind, keys in KERNEL_KINDS if any(k in low for k in keys)), "other")


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: (device seconds summed over
    its CUDA events, {kind: seconds}, [(kernel name, seconds)] largest
    first, the call's host-clock seconds between device synchronizations)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    by_kind = {kind: 0.0 for kind, _ in KERNEL_KINDS + (("other", ()),)}
    for name, sec in by_name.items():
        by_kind[kernel_kind(name)] += sec
    return (sum(by_name.values()), by_kind, sorted(by_name.items(), key=lambda kv: -kv[1]),
            wall)


def measure_step(loss, params, x, y, **kw):
    """One value-and-grad step on the card: ``peak_bytes``, the allocator's
    peak over the step after ``reset_peak_memory_stats`` (what was allocated
    before it included), and, from a second, profiled step, ``busy_s``,
    ``busy_by_kind`` and ``idle_share``, the share of that step's wall time
    in which the card ran nothing (:func:`device_profile`)."""
    dev = x.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    value_and_grad(loss, params, x, y, **kw)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    busy, by_kind, _, wall = device_profile(lambda: value_and_grad(loss, params, x, y, **kw))
    return {"peak_bytes": peak, "busy_s": busy, "busy_by_kind": by_kind,
            "idle_share": 1.0 - busy / wall}


def ref_accuracy(value, grads, ref_value, ref_grads) -> dict:
    """``value_rel_err``, ``grad_max_rel`` and ``grad_cos`` of (value,
    grads) against the reference step's, the gradients' leaves flattened
    and concatenated in one order."""
    ga = torch.cat([grads[f].double().reshape(-1) for f in ref_grads])
    gb = torch.cat([ref_grads[f].double().reshape(-1) for f in ref_grads])
    return {"value_rel_err": abs(float(value) - float(ref_value)) / abs(float(ref_value)),
            "grad_max_rel": float((ga - gb).abs().max() / gb.abs().max()),
            "grad_cos": float(ga @ gb / (ga.norm() * gb.norm()))}


def _params(i: int, d: int, device) -> GPParams:
    """The i-th parameter point of a timed run: a new one each step."""
    return GPParams(torch.tensor(0.001 * i, device=device),
                    torch.full((d,), 0.001 * i, device=device),
                    torch.tensor(-1.0 - 0.001 * i, device=device))


def crossover(sizes, d: int, repeats: int, device, rules=("crps", "dss")):
    """The dense and the fused step of ``rules`` at each n of ``sizes``: one
    record per (n, rule, path) with ``step_s`` (the fastest of ``repeats``
    steps after a warm-up one) and, on a card, ``peak_n2``. The fused cores
    take :func:`auto_block`."""
    records = []
    for n in sizes:
        x, y = (t.to(device) for t in make_data(n, d))
        for rule in rules:
            loss = make_objective(rule, model="exact")
            for path, threshold in (("dense", n + 1), ("fused", 1)):
                with fused_from(threshold):
                    times = []
                    for i in range(repeats + 1):
                        synchronize(device)
                        t0 = time.perf_counter()
                        value_and_grad(loss, _params(i, d, device), x, y)
                        synchronize(device)
                        times.append(time.perf_counter() - t0)
                    rec = {"n": n, "rule": rule, "path": path, "step_s": min(times[1:]),
                           "peak_n2": None}
                    if device.type == "cuda":
                        torch.cuda.reset_peak_memory_stats(device)
                        value_and_grad(loss, _params(0, d, device), x, y)
                        synchronize(device)
                        rec["peak_n2"] = torch.cuda.max_memory_allocated(device) / (4.0 * n * n)
                records.append(rec)
    return records


def ceiling(start: int, step: int, rule: str, d: int, device, max_s: float = CEILING_MAX_S):
    """One value-and-grad of ``rule`` at n = start, start + step, ... on the
    card, under the current precision mode: a record per n with ``step_s``
    (host clock, synchronized, including the first call's set-up) and
    ``peak_n2``, or ``"oom": true`` for the first n that ran out of device
    memory, where the search stops; it stops too after a step longer than
    ``max_s`` seconds. Returns (records, the largest n that fitted or None)."""
    records, fitted, n = [], None, start
    while True:
        torch.cuda.empty_cache()
        rec = {"n": n, "rule": rule}
        try:
            x, y = (t.to(device) for t in make_data(n, d))
            loss = make_objective(rule, model="exact")
            kw = {"generator": torch.Generator(device=device).manual_seed(0)} \
                if rule == "es" else {}
            torch.cuda.reset_peak_memory_stats(device)
            synchronize(device)
            t0 = time.perf_counter()
            value, _ = value_and_grad(loss, _params(0, d, device), x, y, **kw)
            synchronize(device)
            rec.update(step_s=time.perf_counter() - t0, loss=float(value),
                       peak_n2=torch.cuda.max_memory_allocated(device) / (4.0 * n * n),
                       oom=False)
        except torch.cuda.OutOfMemoryError as e:
            rec.update(oom=True, error=str(e).splitlines()[0][:200])
        records.append(rec)
        if rec["oom"]:
            return records, fitted
        fitted = n
        if rec["step_s"] > max_s:
            return records, fitted
        del x, y
        n += step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30720)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--block", type=int, default=0,
                    help="panel width of the fused cores (0: auto_block)")
    ap.add_argument("--rule", default="crps", choices=list(RULES))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--crossover", type=int, nargs="+", default=None, metavar="N",
                    help="time the dense and the fused crps and dss step at each N instead")
    ap.add_argument("--matmul", default="highest", choices=list(MODES),
                    help="precision mode of the step (gpscore_torch.utils.precision)")
    ap.add_argument("--ceiling", type=int, nargs=2, default=None, metavar=("FROM", "STEP"),
                    help="one step at n = FROM, FROM + STEP, ... until the card runs out of "
                         "memory instead")
    ap.add_argument("--ref-grad", action="store_true",
                    help="hold the step's value and gradient to the same step under 'highest'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    with matmul_mode(args.matmul):
        return _run(args, device)


def _run(args, device):
    if args.ceiling:
        if device.type != "cuda":
            raise SystemExit("--ceiling measures the card's memory: it needs --device cuda")
        records, fitted = ceiling(*args.ceiling, args.rule, args.d, device)
        smi = nvidia_smi_line()
        for rec in records:
            print(json.dumps(dict(rec, matmul=args.matmul, nvidia_smi=smi), sort_keys=True),
                  flush=True)
        print(json.dumps({"rule": args.rule, "matmul": args.matmul, "ceiling_n": fitted,
                          "nvidia_smi": smi}), flush=True)
        return records
    if args.crossover:
        records = crossover(args.crossover, args.d, args.repeats, device)
        smi = nvidia_smi_line() if device.type == "cuda" else "cpu"
        for rec in records:
            print(json.dumps(dict(rec, nvidia_smi=smi), sort_keys=True), flush=True)
        return records
    x, y = (t.to(device) for t in make_data(args.n, args.d))
    block = args.block or auto_block(args.n, device=device)
    loss = make_objective(args.rule, model="exact", block=block)

    def es_kw():
        return ({"generator": torch.Generator(device=device).manual_seed(0)}
                if args.rule == "es" else {})

    kw = es_kw()
    rec = {"rule": args.rule, "n": args.n, "d": args.d, "block": block, "matmul": args.matmul}
    t0 = time.perf_counter()
    value, grads = value_and_grad(loss, _params(0, args.d, device), x, y, **kw)
    synchronize(device)
    rec["warmup_s"] = time.perf_counter() - t0
    rec["loss"] = float(value)
    if args.ref_grad:
        with matmul_mode("highest"):
            v0, g0 = value_and_grad(loss, _params(0, args.d, device), x, y, **es_kw())
        rec.update(ref_accuracy(value, grads, v0, g0))
    times = []
    for i in range(1, args.repeats + 1):
        t0 = time.perf_counter()
        value_and_grad(loss, _params(i, args.d, device), x, y, **kw)
        synchronize(device)
        times.append(time.perf_counter() - t0)
    rec["step_s"] = min(times)
    rec["flop"] = step_flop(args.rule, args.n)
    if device.type == "cuda":
        m = measure_step(loss, _params(0, args.d, device), x, y, **kw)
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
