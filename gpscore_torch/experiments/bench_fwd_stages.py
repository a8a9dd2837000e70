"""Where the d-chunked forward's time goes: gram_fwd_kernel_dchunk built with
each of its phases switched off, timed on one CUDA card.

    python -m gpscore_torch.experiments.bench_fwd_stages            # the default shapes
    python -m gpscore_torch.experiments.bench_fwd_stages --shapes 30720x30720x90 20x20x90

The kernel source (gpscore_torch/csrc/gram.cu) is copied into
build/bench_fwd_stages/ with a guard put before each of three phases of
gram_fwd_kernel_dchunk (the copies of a stage, its transposes, the sums of
its features), and built once whole and once with each guard off, with the
flags of ops/_build.py (the builds run side by side). At each shape, under
the plan's tiling (gram_cuda.fwd_dchunk_plan), each build is timed: CUDA
events where K is more than 10^8 elements (torch.profiler loses those
events), else torch.profiler's device time. A build without a phase writes
a wrong K; "whole" is checked against the plain version. One JSON line a
shape (milliseconds by build), then the card's nvidia-smi name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from gpscore_torch.bench_gram import (cuda_ms, device_ms, kernel_inputs, nvidia_smi_line)
from gpscore_torch.ops import _build, gram_cuda

DEFAULT_SHAPES = [(30720, 30720, 90), (30720, 2048, 90), (500, 500, 65), (9700, 20, 130),
                  (500, 20, 90), (20, 20, 90)]
OUT_DIR = _build.BUILD_DIR.parent / "bench_fwd_stages"
# (phase, the statement of gram_fwd_kernel_dchunk it guards, as the source has it).
PHASES = [
    ("copies", "    fd_copy_rows(raw, lay.pr, lay.nb, xs, d,"),
    ("transposes", "      if constexpr (!kXsRaw) fd_transpose<false>(tb,"),
    ("transposes", "      fd_transpose<kXsRaw>(tb + kc * pso,"),
    ("sums", "    if (c > 0 && active) {\n      const int kw = min(kc, d - (c - 1) * kc);"),
]
BUILDS = {"whole": (), "no_copies": ("copies",), "no_transposes": ("transposes",),
          "no_sums": ("sums",), "no_staging": ("copies", "transposes")}


def instrumented_source() -> str:
    """gram.cu with each phase behind `FD_<PHASE>` (1 unless defined 0)."""
    src = (_build.CSRC_DIR / "gram.cu").read_text()
    guards = ""
    for phase, anchor in PHASES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"bench_fwd_stages: gram.cu no longer holds {anchor!r}")
        macro = f"FD_{phase.upper()}"
        if phase == "copies":  # inside the step's copy lambda: leave it early
            src = src.replace(anchor, f"    if (!{macro}) return;\n{anchor}")
        elif phase == "sums":
            src = src.replace(anchor, anchor.replace("if (c > 0", f"if ({macro} && c > 0"))
        else:
            src = src.replace(anchor, anchor.replace("fd_transpose", f"if ({macro}) fd_transpose"))
        if f"#define {macro}" not in guards:
            guards += f"#ifndef {macro}\n#define {macro} 1\n#endif\n"
    return guards + src


def build_all():
    """{build: the gram_fwd_dchunk entry point of its library}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = OUT_DIR / "gram_fwd_stages.cu"
    cu.write_text(instrumented_source())
    procs = {}
    for name, off in BUILDS.items():
        so = OUT_DIR / f"lib_{name}.so"
        flags = [f"-DFD_{p.upper()}=0" for p in off]
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                                             str(so), str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(so)).gram_fwd_dchunk
        fn.argtypes = _build.SIGNATURES["gram_fwd_dchunk"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _shape(text):
    n, m, d = (int(v) for v in text.split("x"))
    return n, m, d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", type=_shape, default=DEFAULT_SHAPES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fwd_stages: torch.cuda.is_available() is false; needs a CUDA card")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fns = build_all()
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for n, m, d in args.shapes:
        xs, xps, sig, _ = kernel_inputs(n, m, d, dev, 99, cotangent=False)
        plan = gram_cuda.fwd_dchunk_plan(n, m, d, sms)
        K = torch.empty((n, m), device=dev)
        big = n * m > 10 ** 8
        rec = {"shape": f"{n}x{m}x{d}", "tile": "%dx%d" % gram_cuda.FD_TILES[plan.tile],
               "tx": plan.col_threads, "ty": plan.row_threads, "stage": plan.stage,
               "timed_by": "cuda_events" if big else "torch.profiler", "ms": {}}
        for name, fn in fns.items():
            def call(fn=fn):
                rc = fn(xs.data_ptr(), xps.data_ptr(), sig.data_ptr(), None, K.data_ptr(), n, m,
                        d, plan.tile, plan.col_threads, plan.row_threads, plan.threads,
                        plan.stage, 0, 1, 0, 0, 0, 0, stream)
                if rc != 0:
                    raise RuntimeError(f"gram_fwd_dchunk ({name}) failed: CUDA error {rc}")
            call()
            if name == "whole":
                err = float((K - gram_cuda.gram_fwd_plain(xs, xps, sig)).abs().max())
                if err > 2e-5:
                    raise RuntimeError(f"whole build at {n}x{m}x{d}: error {err}")
                rec["max_abs_err"] = err
            rec["ms"][name] = (cuda_ms(call, reps=5, warmup=2) if big
                               else device_ms(call, reps=50)[0])
        rec["device"] = torch.cuda.get_device_name(0)
        out.append(rec)
        print(json.dumps(rec), flush=True)
        del xs, xps, K
        torch.cuda.empty_cache()
    print(nvidia_smi_line())
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
