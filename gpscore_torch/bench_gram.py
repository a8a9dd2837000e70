"""Time the Gram kernels against their plain versions on one CUDA card.

    python -m gpscore_torch.bench_gram                        # the default shapes
    python -m gpscore_torch.bench_gram --shapes 8192x8192x8 500x500x8 --out t.json
    python -m gpscore_torch.bench_gram --chunked [--dtype float64]   # the d-chunked shapes
    python -m gpscore_torch.bench_gram --chunked --tiles   # the d-chunked plans' thread tiles
    python -m gpscore_torch.bench_gram --chunked --kernels gram_fwd   # the d-chunked forward

For each shape n x m x d and each kernel (``gram_fwd``, ``gram_bwd_rows``,
``gram_bwd_cols``): the mean time per call of the kernel's wrapper and of its
plain version over 200 back-to-back calls (CUDA events, in the order plain,
kernel, kernel, plain, so that a drift in clocks hits both alike), and the
device time per call (torch.profiler's CUDA events over 50 calls). One
``[time]`` line per kernel and shape, then the card's ``nvidia-smi`` name and
power limit, then one JSON line of all the numbers. ``--chunked`` also
times the forward at all of K at n = 30,720 and its evaluation K(x, x*) at
d = 90 (FWD_CHUNK_SHAPES) with CUDA events alone, kernel against plain
(torch.profiler loses the events of the 30720^2 kernel). With ``--tiles``,
for the d-chunked kernels at each shape instead: the backward plan's tiling
beside the best plan of the other thread tile
(``gram_cuda.dchunk_plan(wide=...)``), and the forward plan's beside the
best plan of each other thread tile (``gram_cuda.fwd_dchunk_plan(tile=...)``),
each checked against the plain version and timed (device time per call).

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
from gpscore_torch.utils.profiling import device_events

DEFAULT_SHAPES = [(500, 20, 8), (20, 20, 8), (500, 500, 8), (9700, 20, 8), (120, 120, 1),
                  (8192, 8192, 8)]
# The d-chunked backward's shapes (past 64 floats, 32 doubles): an exact K_ff
# just past a 64-feature chunk, the pool's FITC K_fu two chunks past, the
# slice set's width on the full pool's FITC Gram, a large-n backward
# block at the song set's width (n = 4096 and 30,720), the FITC-20 K_fu and
# K_uu there; float64 also 500 x 500 x 40 (``--dtype float64``).
CHUNK_SHAPES = [(500, 500, 65), (9700, 20, 130), (9700, 20, 385), (2048, 4096, 90),
                (500, 20, 90), (20, 20, 90), (2048, 30720, 90)]
F64_CHUNK_SHAPES = [(500, 500, 40)]
# The d-chunked forward alone at the large-n step's widths: all of K_hat at n =
# 30,720, d = 90 (one launch a step), and the evaluation's K(x, x*) for 2048
# test points.
FWD_CHUNK_SHAPES = [(30720, 30720, 90), (30720, 2048, 90)]


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
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = device_events(prof)
        per_call = max(1, round(len(dev) / reps))
        calls_seen = len(dev) / per_call
        busy = sum(e.time_range.elapsed_us() for e in dev) / max(calls_seen, 1.0) / 1e3
        if calls_seen >= 0.9 * reps and busy >= floor_ms:
            return busy, per_call
    return None, None


def kernel_inputs(n, m, d, dev, seed, square=False, dtype=torch.float32, cotangent=True):
    """Scaled inputs as the main path makes them: KIN40K-like x in [-1, 1],
    log lengths in [0, 1] (plus log(d / 8) / 2 past 64 features, so that the
    squared distance stays at KIN40K's d = 8 scale), sig = e, g standard normal
    (None without ``cotangent``: a forward needs none); xps = xs when
    ``square`` (a K(u, u)). ``dtype``: float32 or float64 (the same draws,
    cast)."""
    rng = np.random.default_rng(seed)
    ll = rng.uniform(0.0, 1.0, d) + (0.5 * np.log(d / 8.0) if d > 64 else 0.0)
    x = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    xp = x if square else rng.uniform(-1.0, 1.0, (m, d)).astype(np.float32)
    inv = np.exp(-ll.astype(np.float32))
    xs = torch.tensor(x * inv, device=dev, dtype=dtype)
    xps = torch.tensor(xp * inv, device=dev, dtype=dtype)
    g = (torch.tensor(rng.standard_normal((n, m), dtype=np.float32), device=dev, dtype=dtype)
         if cotangent else None)
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


def dchunk_call(cols, plan, xs, xps, sig, g):
    """One launch of the d-chunked backward (the column half when ``cols``)
    under ``plan``, unbatched: d_xps, or (d_xs, rowsum)."""
    n, d = xs.shape
    m = xps.shape[0]
    out = torch.empty((m if cols else n, d), dtype=xs.dtype, device=xs.device)
    row = None if cols else torch.empty(n, dtype=xs.dtype, device=xs.device)
    gram_cuda._launch_plan(gram_cuda._build.load_library(),
                           torch.cuda.current_stream().cuda_stream, [plan],
                           (xs, xps, sig, g, out, row), [0] * 6, n, m, d)
    return out if cols else (out, row)


def time_tiles(shapes, dev, dtype=torch.float32, seed=99, log=print):
    """{"<half> <n>x<m>x<d>": {"plan": ..., "other": ...}}: the d-chunked
    plan's tiling and the best plan of the other thread tile (where one
    fits), each checked against the plain version (fp32 1e-5 + 1e-4 max|ref|,
    fp64 1e-11 + 1e-11 max|ref|) and its device time per call."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    elem = torch.tensor([], dtype=dtype).element_size()
    atol, rtol = (1e-5, 1e-4) if elem == 4 else (1e-11, 1e-11)
    res = {}
    for shape in shapes:
        xs, xps, sig, g = kernel_inputs(*shape, dev, seed, dtype=dtype)
        for cols, name in ((False, "gram_bwd_rows"), (True, "gram_bwd_cols")):
            want = (gram_cuda.gram_bwd_cols_plain if cols else gram_cuda.gram_bwd_rows_plain)(
                xs, xps, sig, g)
            want = (want,) if cols else want
            plan = gram_cuda.dchunk_plan(cols, *shape, sms, elem=elem)
            try:
                other = gram_cuda.dchunk_plan(cols, *shape, sms, elem=elem, wide=not plan.wide)
            except ValueError:  # no tiling of the other thread tile fits
                other = None
            row = {}
            for key, p in (("plan", plan), ("other", other)):
                if p is None:
                    continue
                fn = lambda p=p: dchunk_call(cols, p, xs, xps, sig, g)
                got = fn()
                got = (got,) if cols else got
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                tol = min(atol + rtol * float(b.abs().max()) for b in want)
                assert err <= tol, (name, shape, p, err, tol)
                row[key] = {"tile": "wide" if p.wide else "one pair",
                            "tx": p.walk_threads, "ty": p.own_threads, "blocks": p.blocks,
                            "chunks": p.n_chunks, "max_abs_err": err,
                            "device_ms": device_ms(fn)[0], "ms": cuda_ms(fn)}
            label = f"{name} {'x'.join(map(str, shape))}{'/f64' if elem == 8 else ''}"
            res[label] = row
            log(f"[tiles] {label}: " + "; ".join(
                f"{k} {r['tile']} {r['tx']}x{r['ty']} ({r['blocks']} blocks, {r['chunks']} "
                f"chunks) device {ms_text(r['device_ms'])}, per call {r['ms']:.5f} ms, err "
                f"{r['max_abs_err']:.3g}" for k, r in row.items()))
        del xs, xps, g
    return res


def time_fwd_tiles(shapes, dev, dtype=torch.float32, seed=99, log=print):
    """{"gram_fwd <n>x<m>x<d>": {"plan": ..., "tile <rows>x<cols>": ...}}: the
    d-chunked forward plan's tiling and the best plan of each other thread
    tile, each checked against the plain version (fp32 2e-5, fp64 1e-12) and
    its device time per call (CUDA events where the profiler loses them)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = gram_cuda._build.load_library()
    res = {}
    for shape in shapes:
        xs, xps, sig, _ = kernel_inputs(*shape, dev, seed, dtype=dtype, cotangent=False)
        n, m, d = shape
        elem = xs.element_size()
        tol = 2e-5 if elem == 4 else 1e-12
        want = gram_cuda.gram_fwd_plain(xs, xps, sig)
        plan = gram_cuda.fwd_dchunk_plan(n, m, d, sms, elem=elem)
        plans = {"plan": plan}
        for t in range(len(gram_cuda.FD_TILES)):
            if t != plan.tile:
                plans["tile %dx%d" % gram_cuda.FD_TILES[t]] = gram_cuda.fwd_dchunk_plan(
                    n, m, d, sms, elem=elem, tile=t)
        row = {}
        for key, p in plans.items():
            out = torch.empty((n, m), dtype=dtype, device=dev)

            def fn(p=p, out=out):
                gram_cuda._launch_plan(lib, torch.cuda.current_stream().cuda_stream, [p],
                                       (xs, xps, sig, None, out), [0] * 4, n, m, d)
                return out

            err = float((fn() - want).abs().max())
            assert err <= tol, (shape, p, err, tol)
            big = n * m > 1e8
            row[key] = {"tile": "%dx%d" % gram_cuda.FD_TILES[p.tile], "tx": p.col_threads,
                        "ty": p.row_threads, "stage": p.stage, "blocks": p.blocks,
                        "max_abs_err": err,
                        "device_ms": None if big else device_ms(fn)[0],
                        "ms": cuda_ms(fn, reps=5 if big else 200, warmup=2 if big else 20)}
            del out
        label = f"gram_fwd {'x'.join(map(str, shape))}{'/f64' if elem == 8 else ''}"
        res[label] = row
        log(f"[tiles] {label}: " + "; ".join(
            f"{k} {r['tile']} {r['tx']}x{r['ty']} stage {r['stage']} ({r['blocks']} blocks) "
            f"device {ms_text(r['device_ms'])}, per call {r['ms']:.5f} ms, err "
            f"{r['max_abs_err']:.3g}" for k, r in row.items()))
        del xs, xps, want
        torch.cuda.empty_cache()
    return res


def time_fwd_large(shapes, dev, dtype=torch.float32, seed=99, log=print):
    """{(gram_fwd, n, m, d[, "f64"]): {"ms", "plain_ms"}} with CUDA events
    alone (plain, kernel, kernel, plain), at shapes whose kernel events the
    profiler loses."""
    times = {}
    f64 = dtype == torch.float64
    for shape in shapes:
        kern, plain = kernel_pairs(*kernel_inputs(*shape, dev, seed, dtype=dtype,
                                                  cotangent=False))["gram_fwd"]
        p1, k1, k2, p2 = (cuda_ms(f, reps=r, warmup=2) for f, r in
                          ((plain, 5), (kern, 20), (kern, 20), (plain, 5)))
        key = ("gram_fwd", *shape, *(("f64",) if f64 else ()))
        times[key] = t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "device_ms": None,
                          "plain_device_ms": None}
        log(f"[time] gram_fwd {'x'.join(map(str, key[1:]))}: per call kernel {t['ms']:.5f} ms, "
            f"plain {t['plain_ms']:.5f} ms (CUDA events, back to back)")
        torch.cuda.empty_cache()
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
    ap.add_argument("--chunked", action="store_true",
                    help="the d-chunked shapes (CHUNK_SHAPES, and for gram_fwd "
                         "FWD_CHUNK_SHAPES) instead of --shapes")
    ap.add_argument("--tiles", action="store_true",
                    help="the d-chunked plans beside the other thread tiles' best")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gram: torch.cuda.is_available() is false; needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    dtype = getattr(torch, args.dtype)
    shapes = args.shapes
    if args.chunked:
        shapes = CHUNK_SHAPES + (F64_CHUNK_SHAPES if dtype == torch.float64 else [])
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    wide = [s for s in shapes
            if s[2] > gram_cuda.max_unchunked_d(8 if dtype == torch.float64 else 4)]
    fwd = args.kernels is None or "gram_fwd" in args.kernels
    if args.tiles:
        result["tiles"] = {}
        if args.kernels is None or any(k != "gram_fwd" for k in args.kernels):
            result["tiles"].update(time_tiles(wide, dev, dtype))
        if fwd and hasattr(gram_cuda, "fwd_dchunk_plan"):  # an older checkout has no such plan
            result["tiles"].update(time_fwd_tiles(wide + FWD_CHUNK_SHAPES, dev, dtype))
    else:
        times = time_shapes(shapes, dev, args.kernels, dtype=dtype)
        if args.chunked and fwd:
            times.update(time_fwd_large(FWD_CHUNK_SHAPES, dev, dtype))
        result["times"] = {f"{k[0]} {'x'.join(map(str, k[1:4]))}"
                           f"{'/' + k[4] if len(k) > 4 else ''}": v for k, v in times.items()}
    print(smi)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
