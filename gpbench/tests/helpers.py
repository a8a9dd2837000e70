"""Shared by the benchmark's tests: one run of a cell at a tiny size on the
CPU, through :func:`gpbench.run.main` with the look for a card skipped."""

from __future__ import annotations

import contextlib
import io
import json


def shrink(cell):
    """The cell at a size a CPU test holds: FITC at n = 64 and 30 iterations
    a rule, the exact GP at n = 256 (the fused cores are lowered to it by
    :func:`fused_from`)."""
    c = cell.config
    if c["model"] == "fitc":
        c["n_train"] = 64
        for s in c["schedules"].values():
            s["iters"] = 30
        cell.traffic["restarts"] = min(cell.traffic.get("restarts", 1), 3)
    else:
        c["n"] = 256


@contextlib.contextmanager
def fused_from(n: int):
    from gpscore_torch.fit import objectives

    saved = objectives._FUSED_LOO_MIN_N
    objectives._FUSED_LOO_MIN_N = n
    try:
        yield
    finally:
        objectives._FUSED_LOO_MIN_N = saved


def run_cell(workload, seed=1234567890123, seconds=0.5, mode=None, extra_hook=None):
    """(exit code, the last stdout line parsed or None, stdout) of one CPU run."""
    from gpbench import run

    def hook(cell):
        shrink(cell)
        if extra_hook is not None:
            extra_hook(cell)

    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", "0"]
    if mode:
        argv += ["--mode", mode]
    out = io.StringIO()
    with fused_from(128), contextlib.redirect_stdout(out):
        rc = run.main(argv, device="cpu", cell_hook=hook)
    lines = [l for l in out.getvalue().splitlines() if l.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), out.getvalue()
