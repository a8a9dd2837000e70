"""Run one cell of the benchmark once and print its result line.

    python -m gpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, driver and per-layer readers are found by name
(:mod:`gpbench.spec`). One run:

1. set-up (``setup_s``, from the process's start): the data and parameters
   from ``--seed``, the program's kernels loaded (built on a checkout's first
   run, into ``build/`` inside the checkout), the cell's shapes warmed;
2. the window: the cell's timed path for ``--seconds``, untraced; its
   end-to-end metrics;
3. with ``--trace 1``: bounded profiled spans after the window, reduced to
   the cell's per-layer metrics, ``busy_s``, ``window_s`` and a breakdown;
4. the program's state freed, then the check: the plain float64 reference
   (:mod:`gpbench.reference`) against what the timed path produced, each
   number beside its limit (the traffic mix's ``check.limits``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (end-to-end ones with ``--trace 0``,
per-layer ones with ``--trace 1``), ``device``, ``breakdown`` (traced) and,
last, ``checks``. The run exits non-zero and prints no result where the
machine has no CUDA card or fewer than the cell asks for, where the program
cannot be imported, or where ``jax``, ``jaxlib``, ``flax`` or ``gpscore`` was
loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from gpbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gpscore")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is one of FORBIDDEN; ``gpscore_torch`` is not ``gpscore``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _cache_dirs(root) -> None:
    """Every kernel and build cache inside the checkout, at fixed paths."""
    build = os.path.join(root, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--mode", default=None,
                    help="the program's precision mode for the timed path (default: the "
                         "traffic mix's), or tf32 (TF32 beneath the program); a lower one "
                         "is the check's control")
    return ap.parse_args(argv)


def main(argv=None, *, device=None, cell_hook=None, root=None):
    """One run. ``device`` (a test's CPU) skips the look for a card;
    ``cell_hook(cell)`` may shrink the cell for such a test."""
    args = parse(argv)
    cell = spec.load_cell(args.workload, root=root)
    if cell_hook is not None:
        cell_hook(cell)
    _cache_dirs(str(root or spec.ROOT))
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"gpbench: cell {cell.name!r} needs {cell.chips} CUDA card(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
            return 2
        device = torch.device("cuda", 0)
        from gpbench.frozen.smi import nvidia_smi_line

        log(f"[gpbench] card: {nvidia_smi_line()}")
    device = torch.device(device)
    entry = spec.load_entry(cell.traffic["entry"])
    run = entry.Run(cell, args.seed, device, mode=args.mode)
    run.setup()
    setup_s = time.perf_counter() - T_START
    log(f"[gpbench] {cell.name} seed {args.seed}: set-up {setup_s:.3f} s")

    values = run.window(args.seconds)
    values["setup_s"] = setup_s
    bad = forbidden_modules()
    if bad:
        log(f"gpbench: the process loaded {bad} (JAX or the JAX package); no result")
        return 3
    log(f"[gpbench] window: {json.dumps(values)}")
    e2e = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}

    metrics, extra, breakdown = e2e, {}, None
    if args.trace:
        from gpbench import trace as tr

        t0 = time.perf_counter()
        data = run.trace()
        log(f"[gpbench] traced spans and their reduction: {time.perf_counter() - t0:.3f} s")
        metrics = {}
        for m in cell.per_layer:
            v = spec.load_reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        spans = run.traced_spans
        extra = {"busy_s": sum(s.busy_union_us for s in spans) / 1e6,
                 "window_s": sum(s.wall_s for s in spans)}
        breakdown = tr.breakdown(spans)
        log(f"[gpbench] trace: {json.dumps(metrics)} {json.dumps(extra)} retakes "
            f"{_takes(data)}")

    peak = 0
    if device.type == "cuda":
        peak = max(getattr(run, "setup_peak", 0), torch.cuda.max_memory_allocated(device))
    run.release()
    t0 = time.perf_counter()
    readings = run.check()
    log(f"[gpbench] check: {time.perf_counter() - t0:.3f} s")
    limits = cell.traffic["check"]["limits"]
    checks = {}
    for name, value in readings.items():
        if name in limits:
            checks[name] = {"value": value, "limit": limits[name]}
        else:
            log(f"[gpbench] reading (no limit): {name} = {value!r}")
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and bool(checks)
    bad = forbidden_modules()
    if bad:
        log(f"gpbench: the process loaded {bad} (JAX or the JAX package); no result")
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak), **extra}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: [c["value"], c["limit"]] for k, c in checks.items()}
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


def _takes(data):
    if data.get("kind") == "fitc":
        return {r: v["takes"] for r, v in data["rules"].items()}
    return data.get("takes")


if __name__ == "__main__":
    sys.exit(main())
