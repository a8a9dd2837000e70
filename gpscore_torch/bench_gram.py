"""Time the Gram kernels against their plain versions on one CUDA card.

    python -m gpscore_torch.bench_gram                        # the default shapes
    python -m gpscore_torch.bench_gram --shapes 8192x8192x8 500x500x8 --out t.json

For each shape n x m x d and each kernel (``gram_fwd``, ``gram_bwd_rows``,
``gram_bwd_cols``): the mean time per call of the kernel's wrapper and of its
plain version over 200 back-to-back calls (CUDA events, in the order plain,
kernel, kernel, plain, so that a drift in clocks hits both alike), and the
device time per call (torch.profiler's CUDA events over 50 calls). One
``[time]`` line per kernel and shape, then the card's ``nvidia-smi`` name and
power limit, then one JSON line of all the numbers.

It uses only the wrappers and plain versions of ``gpscore_torch.ops.gram_cuda``,
so the same file can time an older checkout of the package: copy it into
that checkout's ``gpscore_torch/`` and run it from there. ``chip_smoke.py``
times the kernels with the functions here.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from gpscore_torch.ops import gram_cuda

DEFAULT_SHAPES = [(500, 20, 8), (20, 20, 8), (500, 500, 8), (9700, 20, 8), (120, 120, 1),
                  (8192, 8192, 8)]


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps=200, warmup=20):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps=50, warmup=5, floor_ms=0.0):
    """Device time per call of ``fn`` and the number of device events per
    call: torch.profiler's CUDA events (kernels, copies, sets) over ``reps``
    calls. The profiler sometimes drops events on the card's machine: one of
    a window's 50, several windows running, or most of a window (once 20 us
    were read for a 97 us kernel). So the time per call is the events' total
    over the calls that were seen (the events over the events per call,
    ``reps`` where none is missing), and a window that has lost more than a
    tenth of its events, or reads less per call than ``floor_ms`` (a kernel's
    roofline bound), is taken again, up to five times. When all five lost
    events (seen for a few minutes at a time there), the device time is not
    measured: (None, None), and the caller keeps its CUDA-event time alone,
    as at 30720², where the profiler drops that kernel's events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        per_call = max(1, round(len(dev) / reps))
        calls_seen = len(dev) / per_call
        busy = sum(e.time_range.elapsed_us() for e in dev) / max(calls_seen, 1.0) / 1e3
        if calls_seen >= 0.9 * reps and busy >= floor_ms:
            return busy, per_call
    return None, None


def kernel_inputs(n, m, d, dev, seed, square=False, dtype=torch.float32):
    """Scaled inputs as the main path makes them: KIN40K-like x in [-1, 1],
    log lengths in [0, 1] (plus log(d / 8) / 2 past 64 features, so that the
    squared distance stays at KIN40K's d = 8 scale), sig = e, g standard normal;
    xps = xs when ``square`` (a K(u, u)). ``dtype``: float32 or float64
    (the same draws, cast)."""
    rng = np.random.default_rng(seed)
    ll = rng.uniform(0.0, 1.0, d) + (0.5 * np.log(d / 8.0) if d > 64 else 0.0)
    x = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    xp = x if square else rng.uniform(-1.0, 1.0, (m, d)).astype(np.float32)
    inv = np.exp(-ll.astype(np.float32))
    xs = torch.tensor(x * inv, device=dev, dtype=dtype)
    xps = torch.tensor(xp * inv, device=dev, dtype=dtype)
    g = torch.tensor(rng.standard_normal((n, m), dtype=np.float32), device=dev, dtype=dtype)
    return xs, xps, torch.tensor(np.e, dtype=dtype, device=dev), g


def kernel_pairs(xs, xps, sig, g):
    """Kernel name -> (kernel wrapper, plain version), each a thunk."""
    return {
        "gram_fwd": (lambda: gram_cuda.gram_fwd_cuda(xs, xps, sig),
                     lambda: gram_cuda.gram_fwd_plain(xs, xps, sig)),
        "gram_bwd_rows": (lambda: gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g),
                          lambda: gram_cuda.gram_bwd_rows_plain(xs, xps, sig, g)),
        "gram_bwd_cols": (lambda: gram_cuda.gram_bwd_cols_cuda(xs, xps, sig, g),
                          lambda: gram_cuda.gram_bwd_cols_plain(xs, xps, sig, g)),
    }


def time_pair(kern, plain, bound_ms=0.0):
    """Per-call ms of kernel and plain (plain, kernel, kernel, plain) and
    their device ms per call; ``bound_ms``, the least time the work can
    take, is the floor of a believable device time."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "device_ms": device_ms(kern, floor_ms=bound_ms)[0],
            "plain_device_ms": device_ms(plain, floor_ms=bound_ms)[0]}


def ms_text(v) -> str:
    """A time in ms, or "not measured" (a device time the profiler lost)."""
    return "not measured" if v is None else f"{v:.5f} ms"


def time_line(name, shape, t):
    return (f"[time] {name} {'x'.join(map(str, shape))}: per call kernel {t['ms']:.5f} ms, "
            f"plain {t['plain_ms']:.5f} ms; device time per call kernel "
            f"{ms_text(t['device_ms'])}, plain {ms_text(t['plain_device_ms'])}")


def time_shapes(shapes, dev, names=None, seed=99, log=print, dtype=torch.float32):
    """{(kernel, n, m, d): time_pair(...)} at every shape; for float64
    inputs the keys end in "f64" and the bound is the fp64 one."""
    times = {}
    f64 = dtype == torch.float64
    for shape in shapes:
        pairs = kernel_pairs(*kernel_inputs(*shape, dev, seed, dtype=dtype))
        for name, (kern, plain) in pairs.items():
            if names is None or name in names:
                # An older checkout's gram_cuda may have no roofline.
                bound = (gram_cuda.roofline(name, *shape, **({"elem": 8} if f64 else {})).bound_us
                         / 1e3 if hasattr(gram_cuda, "roofline") else 0.0)
                times[(name, *shape, *(("f64",) if f64 else ()))] = t = time_pair(kern, plain,
                                                                                   bound)
                log(time_line(name, (*shape, *(("f64",) if f64 else ())), t))
    return times


def _shape(text):
    n, m, d = (int(v) for v in text.split("x"))
    return n, m, d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", type=_shape, default=DEFAULT_SHAPES,
                    help="n x m x d of K, e.g. 8192x8192x8")
    ap.add_argument("--kernels", nargs="+", default=None,
                    help="only these of gram_fwd, gram_bwd_rows, gram_bwd_cols")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gram: torch.cuda.is_available() is false; needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    times = time_shapes(args.shapes, dev, args.kernels)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "times": {f"{k[0]} {k[1]}x{k[2]}x{k[3]}": v for k, v in times.items()}}
    print(smi)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
