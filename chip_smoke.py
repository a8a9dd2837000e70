"""Smoke run of the PyTorch/CUDA port (gpscore_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, none of whose failures is caught:

1. Device: exits non-zero without CUDA; prints the card's name and power limit.
2. Build: compiles gpscore_torch/csrc/ with nvcc (first use) and prints the
   compiler's register/spill report and the build time; fails unless the
   report shows 0 spill bytes for every instantiation of the three kernels.
3. Kernels against their plain PyTorch versions, on the card, at the main
   path's shapes (500x20x8, 20x20x8), the evaluation's (500x500x8), the full
   pool's (9700x20x8), the size at which the exact GP hands over to the
   large-n path (8192x8192x8), ragged, tall-skinny and short-wide ones that
   exercise the backward kernels' chunks and stages, and d = 12, 16 and 64
   (every DMAX build of the backward); two calls of each kernel on the same
   inputs must be bitwise equal; the synthetic studies' shapes (120x120x1,
   300x120x1, 300x300x1; 120x5x1, 5x5x1, 300x5x1); a row block of the
   large-n backward (2048x30720x8), and gram_fwd alone at the whole large-n
   K(x, x) (30720x30720x8) and the large-n evaluation's K(x, x*)
   (30720x2048x8). Then, at 500x20x8, 20x20x8, 500x500x8, 9700x20x8,
   120x120x1, 8192x8192x8 and 2048x30720x8, and for gram_fwd at
   30720x2048x8, kernel and plain times per call (CUDA events, back to back)
   and device time per call (torch.profiler's CUDA events, summed), and
   gram_fwd's time per call at 30720x30720x8 (CUDA events alone), beside the
   roofline bound (gram_cuda.roofline) and the share of it the kernel's time
   reaches (gpscore_torch/bench_gram.py does the timing).
4. The FITC slice: the five-rule KIN40K FITC-20 fit (n = 500, d = 8, m = 20)
   from the committed initial parameters, 25 GD steps per rule through fit_gd
   on CUDA, then the test-set evaluation. The kernels' launch counters are
   zeroed just before and read just after. At every step the loss and
   gradient on CUDA are held against the CPU's at the same parameters, the
   loop's update is checked, and a free-running CPU fit is compared with the
   CUDA one.
5. A real-size step: five crps steps on the full 9700-row pool.
6. The exact slice: the five kin40k_full rules (crps, nlml, logs, dss, es) on
   the exact GP at n = 500, d = 8, from init_rand_params on a seeded CPU
   generator, 25 GD steps each on CUDA on the kin40k_full schedules (es draws
   from a CUDA generator), then the test-set evaluation; launch counters
   zeroed just before and read just after. The same checks as phase 4, es at
   fixed normals on both sides; then the wall and device-busy time per step,
   and the host syncs of one GD step under torch.cuda.set_sync_debug_mode.
7. The four experiment drivers' main() on CUDA at a cut size; the two
   synthetic ones (which run the kernels at m = 5 and 300x300x1) also with
   --device cpu, their per-rule means held against it.
8. The exact GP at large n (the fused cores of gpscore_torch/ops/loo_fused.py
   over the in-place K_hat^-1 of ops/potri_inplace.py). At n = 2048 and the
   ragged 2000 (block 512, the fused threshold lowered) the loss and gradient
   of crps, logs, interval and nlml on CUDA against the CPU's at the same
   parameters. At n = 30,720, d = 8 (the large_n driver's data, unit
   parameters): the step-0 loss and gradient of crps and nlml against the
   dense path (K materialized), with both steps' peak memory, and both
   against a float64 witness; the in-place Cholesky factor of K_hat and
   cuSOLVER's against a float64 one; then, with the launch counters zeroed just
   before and read just after, 2 fit_gd steps of each of crps, logs,
   interval and nlml and exact_predictive_diag_large at 2048 test points per
   rule; the predictive of the crps fit against the dense exact_predictive's
   diagonal and a float64 solve; per rule the wall time per step, the
   device-busy time and idle share of a profiled step, its device time by
   kind of kernel, the achieved TFLOP/s, and for crps the host syncs of a
   step (none allowed) and the peak memory of a step (at most 1.5 n^2 * 4
   bytes). Last, the large_n experiment's main() at n = 8192, 2 iterations.
   The crps and nlml steps also report their log-signal gradient's O(n)
   closed form (closed_form_log_signal) beside the streamed one against float64.
9. The fold rules at large n (the fold-streamed cores of
   gpscore_torch/ops/fold_stream.py: dss, kc and es one fold at a time off
   the in-place K_hat^-1, fold_k = 4). At n = 2048 and the ragged 2000 (block
   512, the fused threshold lowered) the loss and gradient of dss, kc and es
   (fixed normals) on CUDA against the CPU's. At n = 30,720 (the same data
   and parameters as phase 8; es at fixed normals, 300 draws): the step-0
   loss and gradient of each rule against the stacked composition
   (kfold_exact_precision_fused and the rules) and against a float64 witness
   (float64 K_hat^-1, the fold cotangents by float64 autograd of each fold's
   score, contracted in row blocks), with the peak memory of both fp32 steps
   (the fold-streamed one at most 1.5 n^2 * 4 bytes and under the stacked
   one's); then, with the launch counters zeroed just before and read just
   after, 2 fit_gd steps of each of dss, kc and es; per rule the wall time
   per step, the device-busy time and idle share of a profiled step, its
   device time by kind of kernel and the achieved TFLOP/s, and for dss the
   host syncs of a step (none allowed). Then the large_n experiment's main() at
   n = 8192, 2 iterations of dss, kc and es.

The line before the last is the card's ``nvidia-smi`` name and power limit;
before it, one JSON line describes every kernel: ``ms``, ``plain_ms``,
``bound_ms`` and ``bound_by`` at the FITC path's 500x20x8 (``library_ms`` is
null: no single PyTorch call computes the ARD Gram or either half of its
VJP), ``launches`` summed over the FITC, exact, large-n and large-n fold paths
(each path's count under ``launches_by_path``), and under ``shapes`` the per-call and device
times, the bound and the roofline share at every timed shape, with
``timed_by`` naming the source of the share's time (``torch.profiler``:
``device_ms``; ``cuda_events``: ``ms``, and no ``device_ms``). The last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import importlib
import io
import json
import linecache
import re
import sys
import time
import warnings

import numpy as np
import torch

import gpscore_torch
from gpscore_torch.bench_gram import (cuda_ms, device_ms, kernel_inputs, kernel_pairs,
                                     nvidia_smi_line, time_shapes)
from gpscore_torch.data import kin40k_fitc20_init, kin40k_replicate_split, load_kin40k
from gpscore_torch.experiments import bench_ceiling, large_n
from gpscore_torch.fit import SCHEDULES, eval_predictive_metrics, fit_gd, make_objective
from gpscore_torch.metrics import evaluate_predictive
from gpscore_torch.models import exact as exact_mod
from gpscore_torch.ops import _build, gram_cuda, linalg, loo_fused, potri_inplace
from gpscore_torch.ops.kernels import gram
from gpscore_torch.ops.loo_fused import auto_block
from gpscore_torch.scoring import rules
from gpscore_torch.utils import (init_rand_params, init_unit_params, params_from_numpy,
                                 params_to_numpy)

RULES = ["crps", "nlml", "logs", "dss", "kc"]
SOURCE = "gpscore_torch/csrc/gram.cu"
REPLACES = {
    "gram_fwd": "gpscore/ops/gram_pallas.py:40",  # _gram_kernel
    "gram_bwd_rows": "gpscore/ops/gram_pallas.py:116",  # _bwd
    "gram_bwd_cols": "gpscore/ops/gram_pallas.py:116",  # _bwd
}
KERNEL_SHAPES = [(500, 20, 8), (20, 20, 8), (500, 500, 8), (9700, 20, 8),
                 (4099, 1031, 8), (257, 33, 1), (9700, 1, 8), (9701, 33, 8),
                 (40000, 20, 8), (9700, 20, 64), (500, 500, 16), (20, 8192, 12),
                 (8192, 8192, 8), (120, 120, 1), (300, 120, 1), (300, 300, 1),
                 (120, 5, 1), (5, 5, 1), (300, 5, 1), (2048, 30720, 8)]
# 500x20x8: the FITC K_fu; 20x20x8: its K_uu; 500x500x8: the exact K_ff and
# the evaluation; 9700x20x8: the full pool; 500x500x16 and 20x8192x12: the
# backward's DMAX = 16 build (16-byte xps rows), the second with the row
# kernel's column chunks (5, summed by the last block of a row tile);
# 8192x8192x8: the exact K_ff where the large-n path takes over; 120x120x1,
# 300x120x1, 300x300x1: the synthetic exact study's K_ff and evaluation;
# 120x5x1, 5x5x1, 300x5x1: the synthetic FITC study's K_fu, K_uu and K_su (a
# ragged column tile of m = 5); 2048x30720x8: a row block of the large-n
# backward at n = 30,720 (the cotangent of K(x_b, x)).
SQUARE = [(20, 20), (5, 5)]  # the K(u, u) shapes: xps = xs
TIMED_SHAPES = [(500, 20, 8), (20, 20, 8), (500, 500, 8), (9700, 20, 8), (120, 120, 1),
                (8192, 8192, 8), (2048, 30720, 8)]
# The large-n path's other forward shapes, checked and timed for gram_fwd
# alone: all of K at n = 30,720 (one launch a step and one an evaluation),
# and the evaluation's K(x, x*) for a chunk of 2048 test points.
FWD_SHAPES = [(30720, 30720, 8), (30720, 2048, 8)]
KERNELS = [("gram_fwd", "fwd"), ("gram_bwd_rows", "bwd_rows"), ("gram_bwd_cols", "bwd_cols")]
INSTANTIATIONS = 4  # per kernel: gram_fwd's rows per thread, the backward's DMAX buckets
# The plain forward uses the cross-term form, whose cancellation leaves
# ~1e-7 * |xs|^2 in the exponent; K <= sig = e here.
FWD_ATOL = 2e-5
# Backward: fp32 sums over up to 9700 terms in different orders.
BWD_ATOL, BWD_RTOL = 1e-5, 1e-4
SMOKE_STEPS = 25
LOSS_RTOL = 1e-4  # per-step loss, CUDA vs CPU at the same parameters
# Per-step gradient, CUDA vs CPU at the same parameters, relative to the
# leaf's largest entry: two fp32 implementations (JAX vs the port on the
# CPU) differ by up to 2e-4 there along this fit.
GRAD_RTOL = 1e-3
EXACT_RULES = ["crps", "nlml", "logs", "dss", "es"]
ES_SEED = 0
# The drivers at a cut size, the synthetic ones first; the synthetic ones are
# also run with --device cpu and held against it (the third field).
DRIVER_RUNS = [("simple_full", ["--replicates", "1"], True),
               ("simple_fitc", ["--replicates", "1"], True),
               ("kin40k_full", ["--replicates", "2", "--iters-scale", "0.1"], False),
               ("kin40k_fitc", ["--replicates", "1", "--iters-scale", "0.01"], False)]
# Per-rule test metrics of a driver on CUDA against the same driver on the
# CPU, relative, after the whole free-running fit.
DRIVER_RTOL = 1e-3
METRICS = ("mse", "smse", "logs", "crps", "msll", "coverage95")
# Phase 8.
LARGE_RULES = ["crps", "logs", "interval", "nlml"]
LARGE_N, LARGE_D, LARGE_TEST, LARGE_STEPS = 30720, 8, 2048, 2
SMALL_LARGE = [(2048, 512), (2000, 512)]  # (n, block) against the CPU; 2000 is ragged
# At n = 30,720, step 0: the fused and the dense fp32 paths against each
# other and against a float64 witness (f64_step0), with K_hat's condition
# number ~2e4. On an H100 the readings repeat bit for bit from call to call.
# Losses: the dense crps loss is itself 3.0e-5 off float64, the fused ones
# 2.1e-6 (crps) and 6.3e-8 (nlml).
LARGE_LOSS_RTOL = 1e-4
# Gradients, relative to each leaf's largest entry, per leaf. The log-signal
# gradient of crps is -8.1e-4 at step 0, beside a log-noise gradient of 0.19:
# the error of an fp32 K_hat^-1 is 7.1e-3 (fused) and 6.1e-3 (dense) of that
# small leaf, 3e-5 of the log-noise one. Its O(n) closed form
# (closed_form_log_signal) reads no nearer, 8.2e-3: it subtracts the
# log-noise gradient. The other
# leaves read <= 2.4e-4.
F64_GRAD_RTOL = {"log_signal_sq": 1e-2, "log_length": 1e-3, "log_noise_sq": 1e-3}
# Fused against dense: that shared log-signal error leaves them 1.0e-3 apart
# for crps (2.4e-4 for nlml); the float64 check above is the accuracy check.
LARGE_GRAD_RTOL = 2e-3
# The Cholesky factor of K_hat against float64: cuSOLVER's potrf reads
# 4.6e-6, the in-place one 4.9e-6 (6.8e-5 when its left update was one GEMM
# over all earlier columns).
F64_FACTOR_RTOL = 1e-5
# The crps fit's large-n predictive against the dense one and a float64
# solve, relative to the largest entry: the dense mean and variance are
# themselves 1.7e-5 and 4.3e-5 off float64; the large-n ones read <= 6.7e-5.
LARGE_EVAL_RTOL = 1e-4
F64_ROWS = 2048  # row block of the float64 witness
PEAK_LIMIT_N2 = 1.5  # a crps or fold-rule step's peak memory, in n^2 * 4 bytes
DRIVER_LARGE = ["--n", "8192", "--iters", "2"]  # the large_n driver at a cut size
# Phase 9.
FOLD_RULES = ["dss", "kc", "es"]
FOLD_K, NUM_SIM = 4, 300
ES_NORMALS_SEED = 5  # the fixed normals of the es comparisons
# The fold-streamed step 0 against float64, per leaf: the fold rules'
# log-signal gradients (65, -0.0040 and -0.40 for dss, kc and es) read 4.2e-6,
# 5.6e-5 and 3.1e-5, the log-length ones <= 6.3e-5, the log-noise ones
# <= 2.3e-5.
FOLD_F64_GRAD_RTOL = {"log_signal_sq": 1e-3, "log_length": 1e-3, "log_noise_sq": 1e-3}


def log(*a):
    print(*a, flush=True)


def spills(report):
    """{kernel symbol: (spill store bytes, spill load bytes)} from nvcc's
    ``-Xptxas -v`` report."""
    found, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            found[current] = (int(m.group(1)), int(m.group(2)))
            current = None
    return found


def check_spills(report):
    found = spills(report)
    for name, _ in KERNELS:
        mine = {sym: v for sym, v in found.items() if f"{name}_kernel" in sym}
        assert len(mine) == INSTANTIATIONS, (name, sorted(mine))
        assert all(v == (0, 0) for v in mine.values()), (name, mine)
    log(f"[build] ptxas: 0 spill bytes in all {INSTANTIATIONS} instantiations of "
        + ", ".join(name for name, _ in KERNELS))


def fwd_inputs(n, m, d, dev, seed):
    """xs [n, d] and xps [m, d] uniform in [-1, 1] (xps = xs when n == m, a
    K(x, x)) and sig = e, drawn on the card (a forward needs no cotangent)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.rand((n, d), generator=gen, device=dev) * 2.0 - 1.0
    xps = xs if n == m else torch.rand((m, d), generator=gen, device=dev) * 2.0 - 1.0
    return xs, xps, torch.tensor(np.e, dtype=torch.float32, device=dev)


def phase_kernels(dev):
    err = {k: 0.0 for k in REPLACES}
    for s, (n, m, d) in enumerate(KERNEL_SHAPES):
        xs, xps, sig, g = kernel_inputs(n, m, d, dev, seed=s, square=(n, m) in SQUARE)
        K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
        Kp = gram_cuda.gram_fwd_plain(xs, xps, sig)
        e_f = float((K - Kp).abs().max())
        assert torch.isfinite(K).all() and e_f <= FWD_ATOL, (n, m, d, e_f)
        if (n, m) in SQUARE:
            assert torch.equal(K, K.T), "K(u, u) not exactly symmetric"
            assert torch.equal(torch.diagonal(K), sig.expand(n)), "diagonal != sig"
        d_xs, row = gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g)
        d_xps = gram_cuda.gram_bwd_cols_cuda(xs, xps, sig, g)
        again = (gram_cuda.gram_fwd_cuda(xs, xps, sig),
                 *gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g),
                 gram_cuda.gram_bwd_cols_cuda(xs, xps, sig, g))
        assert all(torch.equal(a, b) for a, b in zip((K, d_xs, row, d_xps), again)), \
            (n, m, d, "two calls on the same inputs differ")
        d_xs_p, row_p = gram_cuda.gram_bwd_rows_plain(xs, xps, sig, g)
        d_xps_p = gram_cuda.gram_bwd_cols_plain(xs, xps, sig, g)
        errs = {}
        for name, a, b in [("d_xs", d_xs, d_xs_p), ("rowsum", row, row_p),
                           ("d_xps", d_xps, d_xps_p)]:
            e = float((a - b).abs().max())
            tol = BWD_ATOL + BWD_RTOL * float(b.abs().max())
            assert torch.isfinite(a).all() and e <= tol, (n, m, d, name, e, tol)
            errs[name] = e
        torch.cuda.synchronize()
        err["gram_fwd"] = max(err["gram_fwd"], e_f)
        err["gram_bwd_rows"] = max(err["gram_bwd_rows"], errs["d_xs"], errs["rowsum"])
        err["gram_bwd_cols"] = max(err["gram_bwd_cols"], errs["d_xps"])
        log(f"[kernels] {n}x{m}x{d}: fwd err {e_f:.3g} (tol {FWD_ATOL}); bwd err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tol {BWD_ATOL} + {BWD_RTOL} * max|ref|); second call bitwise equal")
    for s, (n, m, d) in enumerate(FWD_SHAPES):
        xs, xps, sig = fwd_inputs(n, m, d, dev, seed=s)
        K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
        e_f = float((K - gram_cuda.gram_fwd_plain(xs, xps, sig)).abs().max())
        assert torch.isfinite(K).all() and e_f <= FWD_ATOL, (n, m, d, e_f)
        if n == m:
            assert torch.equal(K, K.T) and torch.equal(torch.diagonal(K), sig.expand(n))
        del K
        err["gram_fwd"] = max(err["gram_fwd"], e_f)
        log(f"[kernels] {n}x{m}x{d} (gram_fwd alone{', K(x, x)' if n == m else ''}): fwd err "
            f"{e_f:.3g} (tol {FWD_ATOL})"
            + ("; exactly symmetric with an exact diagonal" if n == m else ""))
    # Each entry's device_ms is torch.profiler's; at 30720^2 the profiler's
    # windows lost that kernel's events (three in a row), so there the time is
    # CUDA events alone: a call is milliseconds of one kernel, under which the
    # wrapper's host time hides, and the roofline share is taken of "ms".
    times = time_shapes(TIMED_SHAPES, dev, log=log)
    times.update(time_shapes([s for s in FWD_SHAPES if s[0] != s[1]], dev,
                             names=("gram_fwd",), log=log))
    for t in times.values():
        t["timed_by"] = "torch.profiler"
    for n, m, d in FWD_SHAPES:
        if n != m:
            continue
        kern, plain = kernel_pairs(*fwd_inputs(n, m, d, dev, seed=99), None)["gram_fwd"]
        p1, k1, k2, p2 = (cuda_ms(f, reps=r, warmup=2) for f, r in
                          ((plain, 10), (kern, 50), (kern, 50), (plain, 10)))
        times[("gram_fwd", n, m, d)] = t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                                            "timed_by": "cuda_events"}
        log(f"[time] gram_fwd {n}x{m}x{d}: per call kernel {t['ms']:.5f} ms, plain "
            f"{t['plain_ms']:.5f} ms (CUDA events, back to back; no profiler time)")
    for (name, n, m, d), t in times.items():
        bound = gram_cuda.roofline(name, n, m, d)
        t.update(bound_ms=bound.bound_us / 1e3, bound_by=bound.bound_by,
                 roofline_share=bound.bound_us / 1e3 / t.get("device_ms", t["ms"]))
        log(f"[bound] {name} {n}x{m}x{d}: {bound.bytes} bytes, {bound.flops} FLOP: "
            f"{bound.bound_us:.4f} us, by {bound.bound_by}; "
            f"{'device time' if 'device_ms' in t else 'time per call'} reaches "
            f"{t['roofline_share']:.3f} of it")
    return err, times


def leaves_of(p, i=None):
    return {f: (t if i is None else t[i]) for f, t in p.leaves().items()}


def loss_and_grad(loss_fn, params, leaves, x, y, **kw):
    cur = {f: t.detach().clone().requires_grad_() for f, t in leaves.items()}
    loss = loss_fn(params.replace(**cur), x, y, **kw)
    return loss.detach(), dict(zip(cur, torch.autograd.grad(loss, list(cur.values()))))


def phase_slice(dev):
    data = load_kin40k()
    gpu = kin40k_replicate_split(data, 0, device=dev)
    cpu = kin40k_replicate_split(data, 0)
    p0_gpu, p0_cpu = kin40k_fitc20_init(dev), kin40k_fitc20_init()
    gram_cuda.reset_launches()
    fits, metrics = {}, {}
    t0 = time.perf_counter()
    for rule in RULES:
        sched = SCHEDULES[("kin40k_fitc", rule)]
        fits[rule] = fit_gd(make_objective(rule, model="fitc"), p0_gpu, gpu.train_x,
                            gpu.train_y, SMOKE_STEPS, sched.lr, sched.lr_inducing,
                            record_params=True)
        metrics[rule] = eval_predictive_metrics("fitc", fits[rule].params, gpu.train_x,
                                                gpu.train_y, gpu.test_x, gpu.test_y)
    torch.cuda.synchronize()
    launches = dict(gram_cuda.LAUNCHES)
    log(f"[slice] {len(RULES)} rules x {SMOKE_STEPS} steps + evaluation on CUDA: "
        f"{time.perf_counter() - t0:.2f} s; kernel launches {launches}")
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched on the main path"
    for rule in RULES:
        sched = SCHEDULES[("kin40k_fitc", rule)]
        loss_fn = make_objective(rule, model="fitc")
        res = fits[rule]
        hist = res.loss_history.cpu()
        assert torch.isfinite(hist).all() and int(res.stall_iters) == 0, rule
        worst = {"loss": 0.0, "grad": 0.0, "update": 0.0, "record": 0.0}
        for i in range(SMOKE_STEPS):
            at = leaves_of(res.param_history, i)
            nxt = leaves_of(res.params) if i == SMOKE_STEPS - 1 else leaves_of(
                res.param_history, i + 1)
            lg, gg = loss_and_grad(loss_fn, p0_gpu, at, gpu.train_x, gpu.train_y)
            lc, gc = loss_and_grad(loss_fn, p0_cpu, {f: t.cpu() for f, t in at.items()},
                                   cpu.train_x, cpu.train_y)
            worst["loss"] = max(worst["loss"], abs(float(lg) - float(lc)) / abs(float(lc)))
            # The history holds the loss at the recorded evaluation point.
            worst["record"] = max(worst["record"],
                                  abs(float(hist[i]) - float(lg)) / abs(float(lg)))
            for f in gc:
                scale = float(gc[f].abs().max())
                worst["grad"] = max(worst["grad"],
                                    float((gg[f].cpu() - gc[f]).abs().max()) / scale)
                rate = sched.lr_inducing if f == "inducing" else sched.lr
                want = at[f] - rate * gg[f]
                worst["update"] = max(worst["update"], float((nxt[f] - want).abs().max()))
        free = fit_gd(loss_fn, p0_cpu, cpu.train_x, cpu.train_y, SMOKE_STEPS, sched.lr,
                      sched.lr_inducing).loss_history
        rel = ((hist - free).abs() / free.abs()).numpy()
        parted = int(np.argmax(rel > LOSS_RTOL)) if (rel > LOSS_RTOL).any() else None
        log(f"[slice] {rule}: loss {float(hist[0]):.6f} -> {float(hist[-1]):.6f}; at the "
            f"CUDA points, CPU vs CUDA loss rel {worst['loss']:.3g} (tol {LOSS_RTOL}), "
            f"grad rel {worst['grad']:.3g} (tol {GRAD_RTOL}); update err "
            f"{worst['update']:.3g}; history vs re-evaluation rel {worst['record']:.3g}; "
            f"free-running CPU vs CUDA max rel {rel.max():.3g}, first step above "
            f"{LOSS_RTOL}: {parted}")
        assert worst["loss"] <= LOSS_RTOL and worst["grad"] <= GRAD_RTOL, (rule, worst)
        assert worst["record"] <= 1e-6 and worst["update"] <= 1e-6, (rule, worst)
        m_gpu = metrics[rule]
        m_cpu = eval_predictive_metrics("fitc", params_from_numpy(params_to_numpy(res.params)),
                                        cpu.train_x, cpu.train_y, cpu.test_x, cpu.test_y)
        vals = {f: float(getattr(m_gpu, f)) for f in m_gpu._fields}
        assert all(np.isfinite(v) for v in vals.values()), (rule, vals)
        for f in m_gpu._fields:
            a, b = vals[f], float(getattr(m_cpu, f))
            # coverage95 counts test sites: allow one site on the boundary to flip.
            tol = 1.0 / len(cpu.test_y) if f == "coverage95" else 1e-4 * max(1.0, abs(b))
            assert abs(a - b) <= tol, (rule, f, a, b)
        log(f"[eval] {rule} after {SMOKE_STEPS} steps: "
            + ", ".join(f"{k} {v:.5f}" for k, v in vals.items())
            + " (agrees with the CPU at the same parameters)")
    return launches


def phase_pool(dev):
    split = kin40k_replicate_split(load_kin40k(), 0, n_subsample=9700, device=dev)
    sched = SCHEDULES[("kin40k_fitc", "crps")]
    t0 = time.perf_counter()
    res = fit_gd(make_objective("crps", model="fitc"), kin40k_fitc20_init(dev),
                 split.train_x, split.train_y, 5, sched.lr, sched.lr_inducing)
    hist = res.loss_history.cpu()
    wall = time.perf_counter() - t0
    assert split.train_x.shape == (9700, 8) and torch.isfinite(hist).all(), hist
    log(f"[pool] crps on n = 9700, m = 20: 5 steps in {wall:.3f} s, losses "
        + ", ".join(f"{v:.6f}" for v in hist.tolist()))


def exact_init(rule, where):
    """The exact slice's initial parameters: init_rand_params on a seeded CPU
    generator (random scalars for crps, unit ones otherwise), moved."""
    p = init_rand_params(torch.Generator().manual_seed(EXACT_RULES.index(rule)), 8,
                         unit_scalars=(rule != "crps"))
    return p.replace(**{f: t.to(where) for f, t in p.leaves().items()})


def host_syncs(fn):
    """Where ``fn`` makes a synchronizing CUDA call, as torch.cuda's sync
    debug mode reports it: one "file:line" per call."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}: {linecache.getline(w.filename, w.lineno).strip()}"
            for w in caught if "synchroniz" in str(w.message)]


def phase_exact(dev):
    data = load_kin40k()
    gpu = kin40k_replicate_split(data, 0, device=dev)
    cpu = kin40k_replicate_split(data, 0)
    # Fixed normals for the es comparisons, [folds, nb, num_sim] each.
    eps_cpu = tuple(torch.tensor(np.random.default_rng(s).standard_normal((4, 125, 300))
                                 .astype(np.float32)) for s in (11, 12))
    eps_gpu = tuple(e.to(dev) for e in eps_cpu)
    gram_cuda.reset_launches()
    fits, metrics = {}, {}
    t0 = time.perf_counter()
    for rule in EXACT_RULES:
        sched = SCHEDULES[("kin40k_full", rule)]
        gen = torch.Generator(device=dev).manual_seed(ES_SEED) if rule == "es" else None
        fits[rule] = fit_gd(make_objective(rule, model="exact"), exact_init(rule, dev),
                            gpu.train_x, gpu.train_y, SMOKE_STEPS, sched.lr,
                            generator=gen, record_params=True)
        metrics[rule] = eval_predictive_metrics("exact", fits[rule].params, gpu.train_x,
                                                gpu.train_y, gpu.test_x, gpu.test_y)
    torch.cuda.synchronize()
    launches = dict(gram_cuda.LAUNCHES)
    log(f"[exact] {len(EXACT_RULES)} rules x {SMOKE_STEPS} steps + evaluation on CUDA, "
        f"n = 500, d = 8: {time.perf_counter() - t0:.2f} s; kernel launches {launches}")
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched on the exact path"
    for rule in EXACT_RULES:
        sched = SCHEDULES[("kin40k_full", rule)]
        loss_fn = make_objective(rule, model="exact")
        p0_gpu, p0_cpu = exact_init(rule, dev), exact_init(rule, "cpu")
        res = fits[rule]
        hist = res.loss_history.cpu()
        assert torch.isfinite(hist).all() and int(res.stall_iters) == 0, rule
        # es: a generator with the fit's seed replays the fit's own draws.
        replay = torch.Generator(device=dev).manual_seed(ES_SEED) if rule == "es" else None
        fixed = {"eps": eps_gpu} if rule == "es" else {}
        worst = {"loss": 0.0, "grad": 0.0, "update": 0.0, "record": 0.0}
        for i in range(SMOKE_STEPS):
            at = leaves_of(res.param_history, i)
            nxt = leaves_of(res.params) if i == SMOKE_STEPS - 1 else leaves_of(
                res.param_history, i + 1)
            lr_, gr = loss_and_grad(loss_fn, p0_gpu, at, gpu.train_x, gpu.train_y,
                                    generator=replay)
            worst["record"] = max(worst["record"],
                                  abs(float(hist[i]) - float(lr_)) / abs(float(lr_)))
            for f in gr:
                want = at[f] - sched.lr * gr[f]
                worst["update"] = max(worst["update"], float((nxt[f] - want).abs().max()))
            lg, gg = (loss_and_grad(loss_fn, p0_gpu, at, gpu.train_x, gpu.train_y, **fixed)
                      if fixed else (lr_, gr))
            lc, gc = loss_and_grad(loss_fn, p0_cpu, {f: t.cpu() for f, t in at.items()},
                                   cpu.train_x, cpu.train_y,
                                   **({"eps": eps_cpu} if fixed else {}))
            worst["loss"] = max(worst["loss"], abs(float(lg) - float(lc)) / abs(float(lc)))
            for f in gc:
                scale = float(gc[f].abs().max())
                worst["grad"] = max(worst["grad"],
                                    float((gg[f].cpu() - gc[f]).abs().max()) / scale)
        # Free-running, CPU against CUDA (es at fixed normals on both sides).
        if fixed:
            free_gpu = fit_gd(lambda q, x, y, g=None: loss_fn(q, x, y, eps=eps_gpu), p0_gpu,
                              gpu.train_x, gpu.train_y, SMOKE_STEPS, sched.lr).loss_history.cpu()
            free_cpu = fit_gd(lambda q, x, y, g=None: loss_fn(q, x, y, eps=eps_cpu), p0_cpu,
                              cpu.train_x, cpu.train_y, SMOKE_STEPS, sched.lr).loss_history
        else:
            free_gpu = hist
            free_cpu = fit_gd(loss_fn, p0_cpu, cpu.train_x, cpu.train_y, SMOKE_STEPS,
                              sched.lr).loss_history
        rel = ((free_gpu - free_cpu).abs() / free_cpu.abs()).numpy()
        parted = int(np.argmax(rel > LOSS_RTOL)) if (rel > LOSS_RTOL).any() else None
        log(f"[exact] {rule}: loss {float(hist[0]):.6f} -> {float(hist[-1]):.6f}; at the "
            f"CUDA points{' (es at fixed normals)' if fixed else ''}, CPU vs CUDA loss rel "
            f"{worst['loss']:.3g} (tol {LOSS_RTOL}), grad rel {worst['grad']:.3g} (tol "
            f"{GRAD_RTOL}); update err {worst['update']:.3g}; history vs re-evaluation rel "
            f"{worst['record']:.3g}; free-running CPU vs CUDA max rel {rel.max():.3g}, first "
            f"step above {LOSS_RTOL}: {parted}")
        assert worst["loss"] <= LOSS_RTOL and worst["grad"] <= GRAD_RTOL, (rule, worst)
        assert worst["record"] <= 1e-6 and worst["update"] <= 1e-6, (rule, worst)
        m_gpu = metrics[rule]
        m_cpu = eval_predictive_metrics("exact", params_from_numpy(params_to_numpy(res.params)),
                                        cpu.train_x, cpu.train_y, cpu.test_x, cpu.test_y)
        vals = {f: float(getattr(m_gpu, f)) for f in m_gpu._fields}
        assert all(np.isfinite(v) for v in vals.values()), (rule, vals)
        for f in m_gpu._fields:
            a, b = vals[f], float(getattr(m_cpu, f))
            tol = 1.0 / len(cpu.test_y) if f == "coverage95" else 1e-4 * max(1.0, abs(b))
            assert abs(a - b) <= tol, (rule, f, a, b)
        log(f"[exact-eval] {rule} after {SMOKE_STEPS} steps: "
            + ", ".join(f"{k} {v:.5f}" for k, v in vals.items())
            + " (agrees with the CPU at the same parameters)")
    # Time per step, warm, outside the counted run: three 25-step fits per
    # rule (host clock, synchronized), device-busy time over 5 steps, and the
    # host syncs of one step.
    for rule in EXACT_RULES:
        sched = SCHEDULES[("kin40k_full", rule)]
        loss_fn = make_objective(rule, model="exact")
        p0 = exact_init(rule, dev)
        gen = torch.Generator(device=dev).manual_seed(ES_SEED)

        def fit(steps):
            return fit_gd(loss_fn, p0, gpu.train_x, gpu.train_y, steps, sched.lr, generator=gen)

        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fit(SMOKE_STEPS)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) / SMOKE_STEPS * 1e3)
        busy, n_ops = device_ms(lambda: fit(5), reps=1, warmup=1)
        syncs = [host_syncs(lambda: fit(1)) for _ in range(2)]
        log(f"[exact-time] {rule}: wall per step " + ", ".join(f"{w:.3f}" for w in walls)
            + f" ms (three {SMOKE_STEPS}-step fits); device busy {busy / 5:.4f} ms and "
            f"{n_ops / 5:.0f} device ops per step; host syncs in one GD step, twice: "
            f"{len(syncs[0])}, {len(syncs[1])} {sorted(set(syncs[0] + syncs[1]))}")
    return launches


def phase_drivers(dev):
    for name, argv, against_cpu in DRIVER_RUNS:
        mod = importlib.import_module(f"gpscore_torch.experiments.{name}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the sweep's own per-rule lines
            res = mod.main(argv + ["--device", str(dev)])
        wall = time.perf_counter() - t0
        for rule, rec in res.items():
            assert rec["num_failed"] == 0, (name, rule, rec)
            vals = [rec[f] for f in METRICS]
            assert all(v is not None and np.isfinite(v) for v in vals), (name, rule, rec)
        held = ""
        if against_cpu:
            with contextlib.redirect_stdout(io.StringIO()):
                ref = mod.main(argv + ["--device", "cpu"])
            # coverage95 counts test sites: allow one site on the boundary to flip.
            sites = len(mod.make_data(0)[3])
            worst = 0.0
            for rule, rec in res.items():
                for f in METRICS:
                    a, b = rec[f], ref[rule][f]
                    tol = 1.0 / sites if f == "coverage95" else DRIVER_RTOL * abs(b)
                    assert abs(a - b) <= tol, (name, rule, f, a, b)
                    if f != "coverage95":
                        worst = max(worst, abs(a - b) / abs(b))
            held = (f"; per-rule means against --device cpu: max rel {worst:.3g} "
                    f"(tol {DRIVER_RTOL}; coverage95 within one of {sites} sites)")
        log(f"[drivers] {name} {' '.join(argv)} --device {dev}: {wall:.2f} s; wall_s per rule "
            + ", ".join(f"{r} {rec['wall_s']:.2f}" for r, rec in res.items())
            + "; test crps per rule " + ", ".join(f"{r} {rec['crps']:.5f}"
                                                   for r, rec in res.items()) + held)


fused_from = bench_ceiling.fused_from


def grad_rel(got, want):
    """The largest gradient difference, relative to each leaf's largest entry."""
    return max(float((got[f].cpu() - want[f].cpu()).abs().max()) / float(want[f].abs().max())
               for f in want)


def rel_max(got, want):
    """max |got - want| over max |want|, in float64."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


def peak_of(fn):
    """(fn(), the allocator's peak bytes while it ran, after a reset)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def f64_sqdist(a, b):
    """The d per-dimension squared differences [n, m] of rows of a and b."""
    return [(a[:, k, None] - b[None, :, k]) ** 2 for k in range(a.shape[1])]


def f64_factor(x, p):
    """(xs, sig, noise, L) in float64 on x's device: the scaled inputs, the
    signal and noise variances, and cuSOLVER's Cholesky factor of K_hat =
    K(x, x) + noise I, built in row blocks by direct differences."""
    f64 = torch.float64
    xs = x.to(f64) * torch.exp(-p.log_length.to(f64))
    sig, noise = torch.exp(p.log_signal_sq.to(f64)), torch.exp(p.log_noise_sq.to(f64))
    n = x.shape[0]
    K = torch.empty((n, n), dtype=f64, device=x.device)
    for r0 in range(0, n, F64_ROWS):
        K[r0:r0 + F64_ROWS] = sig * torch.exp(-0.5 * sum(f64_sqdist(xs[r0:r0 + F64_ROWS], xs)))
    K.diagonal().add_(noise)
    return xs, sig, noise, torch.linalg.cholesky(K)


def f64_inverse(x, y, p):
    """(xs, sig, noise, K_hat^-1, a = K_hat^-1 y, half log-det of K_hat) in
    float64, through the float64 factor and cuSOLVER's inverse."""
    xs, sig, noise, L = f64_factor(x, p)
    half_logdet = torch.log(L.diagonal()).sum()
    Kinv = torch.cholesky_inverse(L)
    del L
    return xs, sig, noise, Kinv, Kinv @ y.to(torch.float64), half_logdet


def f64_fold_loss(rule, A, a_f, y_f, eps_f):
    """One fold's score in float64 from the fold precision A = [K_hat^-1]_ff
    and a_f = [K_hat^-1 y]_f. dss and kc are written out here, apart from the
    port's rules; es goes through the port's energy_score_precision in
    float64, so only its K_hat^-1 and fold-adjoint chain is independent of
    the port (the rule itself is held against the JAX package's in the CPU
    tests)."""
    La = torch.linalg.cholesky(A)
    r = torch.cholesky_solve(a_f[:, None], La)[:, 0]  # y_f - mean
    if rule == "dss":
        return (0.5 * len(r) * np.log(2.0 * np.pi) - torch.log(La.diagonal()).sum()
                + 0.5 * r @ (A @ r))
    if rule == "kc":
        sd = torch.sqrt(torch.cholesky_inverse(La).diagonal())
        z = r / sd
        pdf = torch.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)
        return torch.mean(sd * (z * torch.erf(z / np.sqrt(2.0)) + 2.0 * pdf - 1.0 / np.sqrt(np.pi)))
    return rules.energy_score_precision(y_f - r, La, y_f, NUM_SIM, 1.0, eps=eps_f)


def f64_step0(rule, x, y, p, eps=None, inverse=None):
    """The float64 witness of an exact objective: (loss, {leaf: gradient}) in
    the three log-parameters. K_hat^-1 comes from the float64 factor
    (``inverse``: an :func:`f64_inverse` to reuse); G = dloss/dK_hat is then
    contracted with dK/dtheta in row blocks. nlml: G = (K^-1 - a a^T) / 2.
    crps, through a = K^-1 y and diag(K^-1): G = -(K^-1 a_bar) a^T - K^-1
    diag(d_bar) K^-1. A fold rule (dss, kc, es at the normals ``eps`` =
    (e, e')), through a and the fold blocks A_f = [K^-1]_ff: a_bar and A_bar_f
    by float64 autograd of each fold's score (:func:`f64_fold_loss`), G =
    -(K^-1 a_bar) a^T - sum_f K^-1[:, f] A_bar_f K^-1[f, :]. Peak ~3 n^2 * 8
    bytes."""
    xs, sig, noise, Kinv, a, half_logdet = inverse or f64_inverse(x, y, p)
    n, y64 = x.shape[0], y.to(torch.float64)
    if rule == "nlml":
        loss = 0.5 * n * np.log(2.0 * np.pi) + half_logdet + 0.5 * (y64 @ a)

        def g_rows(r0, r1):
            return 0.5 * (Kinv[r0:r1] - a[r0:r1, None] * a[None, :])
    elif rule == "crps":  # on the LOO predictive
        a_, d_ = a.clone().requires_grad_(), Kinv.diagonal().clone().requires_grad_()
        loss = rules.crps_gaussian(y64 - a_ / d_, 1.0 / d_, y64)
        a_bar, d_bar = torch.autograd.grad(loss, (a_, d_))
        b = Kinv @ a_bar

        def g_rows(r0, r1):
            return -(b[r0:r1, None] * a[None, :]) - (Kinv[r0:r1] * d_bar) @ Kinv
    else:
        nb = n // FOLD_K
        folds = [slice(f * nb, (f + 1) * nb) for f in range(FOLD_K)]
        loss, a_bar, A_bar = 0.0, torch.empty_like(a), []
        for f, s in enumerate(folds):
            A, a_f = Kinv[s, s].clone().requires_grad_(), a[s].clone().requires_grad_()
            eps_f = None if eps is None else tuple(e[f].to(torch.float64) for e in eps)
            loss_f = torch.sum(f64_fold_loss(rule, A, a_f, y64[s], eps_f))
            A_bar_f, a_bar[s] = torch.autograd.grad(loss_f, (A, a_f))
            A_bar.append(A_bar_f)
            loss = loss + loss_f.detach()
        b = Kinv @ a_bar

        def g_rows(r0, r1):
            G = -(b[r0:r1, None] * a[None, :])
            for s, A_bar_f in zip(folds, A_bar):
                G -= (Kinv[r0:r1, s] @ A_bar_f) @ Kinv[s]
            return G
    sig_bar = torch.zeros((), dtype=torch.float64, device=x.device)
    len_bar = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    trace = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0 in range(0, n, F64_ROWS):
        G = g_rows(r0, min(r0 + F64_ROWS, n))
        trace += G.diagonal(offset=r0).sum()
        diffs = f64_sqdist(xs[r0:r0 + F64_ROWS], xs)
        C = G * (sig * torch.exp(-0.5 * sum(diffs)))
        sig_bar += C.sum()
        len_bar += torch.stack([(C * dk).sum() for dk in diffs])
    return float(loss.detach()), {"log_signal_sq": sig_bar, "log_length": len_bar,
                                  "log_noise_sq": noise * trace}


def f64_predictive(x, y, xt, p):
    """The noise-inclusive predictive's mean and variances at xt, in float64
    through the float64 factor."""
    xs, sig, noise, L = f64_factor(x, p)
    xts = xt.to(torch.float64) * torch.exp(-p.log_length.to(torch.float64))
    ks = sig * torch.exp(-0.5 * sum(f64_sqdist(xs, xts)))  # [n, t]
    mean = ks.T @ torch.cholesky_solve(y.to(torch.float64)[:, None], L)[:, 0]
    V = torch.linalg.solve_triangular(L, ks, upper=False)
    return mean, noise + sig - torch.sum(V * V, dim=0)


def closed_form_log_signal(p0, x, y, noise_bar):
    """{rule: the log-signal gradient in its O(n) closed form} for crps and
    nlml, from ``noise_bar``, {rule: the fused step's log-noise gradient}.
    K = K_hat - noise I gives sum K_hat_bar o K = tr(K_hat_bar K_hat) -
    log_noise_bar, and the trace collapses: -a_bar^T a - d_bar^T d for a LOO
    rule (a = K_hat^-1 y, d = diag K_hat^-1), (n - y^T a) / 2 for the NLML."""
    with torch.no_grad():
        a, d = loo_fused.ard_loo_solve_diag(p0.log_signal_sq, p0.log_length, p0.log_noise_sq, x, y)
    a_, d_ = a.clone().requires_grad_(), d.clone().requires_grad_()
    a_bar, d_bar = torch.autograd.grad(rules.crps_gaussian(y - a_ / d_, 1.0 / d_, y), (a_, d_))
    trace = {"crps": -torch.dot(a_bar, a) - torch.dot(d_bar, d),
             "nlml": 0.5 * (x.shape[0] - torch.dot(y, a))}
    return {rule: trace[rule] - noise_bar[rule] for rule in trace}


def phase_large_n(dev):
    vg = bench_ceiling.value_and_grad
    # 1. Small n, the fused cores on CUDA against the CPU at the same parameters.
    for n, block in SMALL_LARGE:
        x, y, _, _ = large_n.make_data(n, LARGE_D, 0)
        p_cpu = init_unit_params(LARGE_D, isotropic=False)
        p_gpu = init_unit_params(LARGE_D, isotropic=False, device=dev)
        worst = {"loss": 0.0, "grad": 0.0}
        with fused_from(1):
            for rule in LARGE_RULES:
                loss = make_objective(rule, model="exact", block=block)
                lg, gg = vg(loss, p_gpu, x.to(dev), y.to(dev))
                lc, gc = vg(loss, p_cpu, x, y)
                worst["loss"] = max(worst["loss"], abs(float(lg) - float(lc)) / abs(float(lc)))
                worst["grad"] = max(worst["grad"], grad_rel(gg, gc))
        log(f"[large_n] n = {n}, block {block}, fused {'/'.join(LARGE_RULES)}: CPU vs CUDA loss "
            f"rel {worst['loss']:.3g} (tol {LOSS_RTOL}), grad rel {worst['grad']:.3g} (tol "
            f"{GRAD_RTOL})")
        assert worst["loss"] <= LOSS_RTOL and worst["grad"] <= GRAD_RTOL, (n, worst)

    # 2. Full size: the large_n driver's data, unit parameters.
    n, n2 = LARGE_N, 4.0 * LARGE_N * LARGE_N
    x, y, xt, yt = (t.to(dev) for t in large_n.make_data(n, LARGE_D, LARGE_TEST))
    p0 = init_unit_params(LARGE_D, isotropic=False, device=dev)
    block = auto_block(n, device=dev)
    log(f"[large_n] n = {n}, d = {LARGE_D}, {LARGE_TEST} test points; auto_block {block}")
    streamed, g64s = {}, {}
    for rule in ("crps", "nlml"):
        loss = make_objective(rule, model="exact")
        with fused_from(n + 1):  # the dense path: K, the Cholesky and K^-1 materialized
            (vd, gd), peak_d = peak_of(lambda: vg(loss, p0, x, y))
        (vf, gf), peak_f = peak_of(lambda: vg(loss, p0, x, y))
        rel, g_rel = abs(float(vf) - float(vd)) / abs(float(vd)), grad_rel(gf, gd)
        log(f"[large_n] {rule} step 0: fused {float(vf):.7g} vs dense {float(vd):.7g}, loss rel "
            f"{rel:.3g} (tol {LARGE_LOSS_RTOL}), grad rel {g_rel:.3g} (tol {LARGE_GRAD_RTOL}); "
            f"peak memory of the step, n^2 * 4 B: fused {peak_f / n2:.3f}, dense {peak_d / n2:.3f}")
        torch.cuda.empty_cache()
        v64, g64 = f64_step0(rule, x, y, p0)
        near = {k: (abs(float(v) - v64) / abs(v64),
                    {f: grad_rel({f: g[f]}, {f: g64[f]}) for f in g64})
                for k, v, g in (("fused", vf, gf), ("dense", vd, gd))}
        log(f"[large_n] {rule} step 0 against float64 (loss {v64:.10g}, log-signal gradient "
            f"{float(g64['log_signal_sq']):.6g}, log-noise {float(g64['log_noise_sq']):.6g}): "
            + "; ".join(
            f"{k} loss rel {lr_:.3g}, grad rel by leaf "
            + ", ".join(f"{f} {e:.3g}" for f, e in ge.items()) for k, (lr_, ge) in near.items())
            + f" (tol {LARGE_LOSS_RTOL}, {F64_GRAD_RTOL} for fused)")
        assert rel <= LARGE_LOSS_RTOL and g_rel <= LARGE_GRAD_RTOL, (rule, rel, g_rel)
        lr_, ge = near["fused"]
        assert lr_ <= LARGE_LOSS_RTOL and all(e <= F64_GRAD_RTOL[f] for f, e in ge.items()), \
            (rule, lr_, ge)
        if rule == "crps":
            assert peak_f <= PEAK_LIMIT_N2 * n2, (peak_f / n2, PEAK_LIMIT_N2)
        streamed[rule], g64s[rule] = gf, g64
        torch.cuda.empty_cache()
    f = "log_signal_sq"
    closed = closed_form_log_signal(p0, x, y, {r: g["log_noise_sq"] for r, g in streamed.items()})
    for rule, g64 in g64s.items():
        log(f"[large_n] {rule} step 0, log-signal gradient against float64: streamed sum of "
            f"rowsums (the gradient) {grad_rel({f: streamed[rule][f]}, {f: g64[f]}):.3g}, closed "
            f"form {grad_rel({f: closed[rule]}, {f: g64[f]}):.3g}")
    # The Cholesky factor of K_hat: the in-place pipeline's and cuSOLVER's
    # potrf (what the dense path uses), against float64.
    with torch.no_grad():
        L64 = f64_factor(x, p0)[3]
        lp = (p0.log_signal_sq, p0.log_length, p0.log_noise_sq, x)
        e_ip = rel_max(potri_inplace.ard_gram_chol_inplace(*lp, block)[0], L64)
        e_cs = rel_max(linalg.chol_factor(potri_inplace.khat_full(*lp)), L64)
        del L64
        torch.cuda.empty_cache()
    log(f"[large_n] Cholesky factor of K_hat at step 0 against float64, relative to the largest "
        f"entry: in-place (block {block}) {e_ip:.3g}, cuSOLVER potrf {e_cs:.3g} (tol "
        f"{F64_FACTOR_RTOL} for in-place)")
    assert e_ip <= F64_FACTOR_RTOL, (e_ip, e_cs)

    # The counted run: 2 GD steps and the large-n evaluation per rule.
    gram_cuda.reset_launches()
    fits, walls, preds = {}, {}, {}
    for rule in LARGE_RULES:
        sched = large_n.schedule_for(rule, n, LARGE_STEPS)
        loss = make_objective(rule, model="exact")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits[rule] = fit_gd(loss, p0, x, y, LARGE_STEPS, sched.lr)
        torch.cuda.synchronize()
        walls[rule] = (time.perf_counter() - t0) / LARGE_STEPS
        preds[rule] = exact_mod.exact_predictive_diag_large(x, y, xt, fits[rule].params,
                                                            chunk=LARGE_TEST)
    torch.cuda.synchronize()
    launches = dict(gram_cuda.LAUNCHES)
    log(f"[large_n] {len(LARGE_RULES)} rules x {LARGE_STEPS} steps + evaluation, n = {n}: "
        f"kernel launches {launches}")
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched on the large_n path"
    for rule in LARGE_RULES:
        hist = fits[rule].loss_history.cpu()
        assert torch.isfinite(hist).all() and int(fits[rule].stall_iters) == 0, (rule, hist)
        vals = {k: float(v) for k, v in evaluate_predictive(
            preds[rule].mean, preds[rule].cov, yt, y)._asdict().items()}
        assert all(np.isfinite(v) for v in vals.values()), (rule, vals)
        log(f"[large_n-eval] {rule}: loss {float(hist[0]):.6f} -> {float(hist[-1]):.6f}; "
            + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
    # The crps fit's predictive against the dense one and a float64 solve.
    p = fits["crps"].params
    with torch.no_grad():
        sig, ll = p.log_signal_sq, p.log_length
        want = exact_mod.exact_predictive(gram(xt, x, sig, ll), gram(x, x, sig, ll),
                                          gram(xt, xt, sig, ll), y, p.noise_sq)
        dense = (want.mean, torch.diagonal(want.cov).clone())
        del want
        torch.cuda.empty_cache()
        f64 = f64_predictive(x, y, xt, p)
        torch.cuda.empty_cache()

    def gaps(got, ref):
        return tuple(rel_max(g, r) for g, r in zip(got, ref))

    large = (preds["crps"].mean, preds["crps"].cov)
    e = {"large-n vs dense": gaps(large, dense), "large-n vs float64": gaps(large, f64),
         "dense vs float64": gaps(dense, f64)}
    log("[large_n-eval] crps fit's predictive, relative to the largest entry: "
        + "; ".join(f"{k} mean {m:.3g}, variance {v:.3g}" for k, (m, v) in e.items())
        + f" (tol {LARGE_EVAL_RTOL} for large-n)")
    for k in ("large-n vs dense", "large-n vs float64"):
        assert max(e[k]) <= LARGE_EVAL_RTOL, (k, e[k])

    # 3. Time, device time by kind, FLOP rate, host syncs and memory per rule.
    for rule in LARGE_RULES:
        loss = make_objective(rule, model="exact")
        m = bench_ceiling.measure_step(loss, p0, x, y)
        flop = bench_ceiling.step_flop(rule, n)
        kinds = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in m["busy_by_kind"].items())
        line = (f"[large_n-time] {rule}: wall per GD step {walls[rule]:.4f} s; device busy "
                f"{m['busy_s']:.4f} s of a profiled value-and-grad (ms by kind: {kinds}), idle "
                f"share {m['idle_share']:.4f}; {flop / walls[rule] / 1e12:.2f} TFLOP/s "
                f"({flop:.3g} FLOP); peak memory {m['peak_bytes'] / n2:.3f} n^2 * 4 B")
        if rule in ("crps", "nlml"):
            leaves = {f: t.clone().requires_grad_() for f, t in p0.leaves().items()}
            fwd_s, fwd_kinds, _, _ = bench_ceiling.device_profile(
                lambda: loss(p0.replace(**leaves), x, y))
            line += ("; forward alone busy " f"{fwd_s:.4f} s (ms by kind: "
                     + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in fwd_kinds.items()) + ")")
        if rule == "crps":
            sched = large_n.schedule_for(rule, n, 1)
            syncs = [w for w in host_syncs(lambda: fit_gd(loss, p0, x, y, 1, sched.lr))
                     if "set_sync_debug_mode" not in w]
            line += f"; host syncs in one GD step: {len(syncs)} {syncs}"
            assert not syncs, syncs
            assert m["peak_bytes"] <= PEAK_LIMIT_N2 * n2, m["peak_bytes"] / n2
        log(line)
    _, _, top, _ = bench_ceiling.device_profile(
        lambda: vg(make_objective("crps", model="exact"), p0, x, y))
    log("[large_n-time] crps value-and-grad, largest device kernels (ms): "
        + "; ".join(f"{name[:90]} {sec * 1e3:.2f}" for name, sec in top[:10]))

    # 4. The large_n experiment driver at a cut size.
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = large_n.main(DRIVER_LARGE + ["--device", str(dev)])
    for rule, rec in res.items():
        assert all(np.isfinite(rec[k]) for k in ("loss_first", "loss_last", *METRICS)), rec
    log(f"[large_n-driver] {' '.join(DRIVER_LARGE)}: {time.perf_counter() - t0:.2f} s; "
        + "; ".join(f"{r} s_per_iter_steady {rec['s_per_iter_steady']:.4f}, test crps "
                    f"{rec['crps']:.5f}" for r, rec in res.items()))
    return launches


def stacked_fold_loss(rule, eps):
    """The fold rule through the stacked composition: the fused k-fold core's
    [k, nb, nb] blocks (kfold_exact_precision_fused), factored at once, and
    the rules on them, differentiated by autograd."""
    def loss(params, x, y):
        p = exact_mod.kfold_exact_precision_fused(x, y, params, FOLD_K)
        y_b = y.reshape(p.mean.shape)
        if rule == "dss":
            return torch.sum(rules.dss_precision(p.mean, p.chol_prec, y_b))
        if rule == "kc":
            return rules.crps_kfold(p.mean, linalg.inv_diag_from_chol(p.chol_prec), y_b)
        return torch.sum(rules.energy_score_precision(p.mean, p.chol_prec, y_b, NUM_SIM, 1.0,
                                                      eps=eps))
    return loss


def fold_eps(n, where, seed=ES_NORMALS_SEED):
    """Fixed normals (e, e'), each [FOLD_K, n / FOLD_K, NUM_SIM], made on the
    CPU from a seed and moved."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((FOLD_K, n // FOLD_K, NUM_SIM), generator=gen).to(where)
                 for _ in range(2))


def phase_folds(dev):
    vg = bench_ceiling.value_and_grad
    # 1. Small n, the fold-streamed cores on CUDA against the CPU.
    for n, block in SMALL_LARGE:
        x, y, _, _ = large_n.make_data(n, LARGE_D, 0)
        p_cpu = init_unit_params(LARGE_D, isotropic=False)
        p_gpu = init_unit_params(LARGE_D, isotropic=False, device=dev)
        eps_cpu = fold_eps(n, "cpu")
        eps_gpu = tuple(e.to(dev) for e in eps_cpu)
        worst = {"loss": 0.0, "grad": 0.0}
        with fused_from(1):
            for rule in FOLD_RULES:
                loss = make_objective(rule, model="exact", fold_k=FOLD_K, num_sim=NUM_SIM,
                                      block=block)
                lg, gg = vg(loss, p_gpu, x.to(dev), y.to(dev),
                            **({"eps": eps_gpu} if rule == "es" else {}))
                lc, gc = vg(loss, p_cpu, x, y, **({"eps": eps_cpu} if rule == "es" else {}))
                worst["loss"] = max(worst["loss"], abs(float(lg) - float(lc)) / abs(float(lc)))
                worst["grad"] = max(worst["grad"], grad_rel(gg, gc))
        log(f"[folds] n = {n}, block {block}, fold-streamed {'/'.join(FOLD_RULES)}: CPU vs CUDA "
            f"loss rel {worst['loss']:.3g} (tol {LOSS_RTOL}), grad rel {worst['grad']:.3g} (tol "
            f"{GRAD_RTOL})")
        assert worst["loss"] <= LOSS_RTOL and worst["grad"] <= GRAD_RTOL, (n, worst)

    # 2. Full size, step 0: against the stacked composition and float64.
    n, n2 = LARGE_N, 4.0 * LARGE_N * LARGE_N
    x, y, _, _ = (t.to(dev) for t in large_n.make_data(n, LARGE_D, LARGE_TEST))
    p0 = init_unit_params(LARGE_D, isotropic=False, device=dev)
    eps = fold_eps(n, dev)
    fused, stacked = {}, {}
    for rule in FOLD_RULES:
        kw = {"eps": eps} if rule == "es" else {}
        loss = make_objective(rule, model="exact", fold_k=FOLD_K, num_sim=NUM_SIM)
        (vf, gf), peak_f = peak_of(lambda: vg(loss, p0, x, y, **kw))
        torch.cuda.empty_cache()
        (vs, gs), peak_s = peak_of(lambda: vg(stacked_fold_loss(rule, eps), p0, x, y))
        torch.cuda.empty_cache()
        fused[rule] = (vf, gf)
        stacked[rule] = (vs, gs)
        rel, g_rel = abs(float(vf) - float(vs)) / abs(float(vs)), grad_rel(gf, gs)
        log(f"[folds] {rule} step 0: fold-streamed {float(vf):.7g} vs stacked {float(vs):.7g}, "
            f"loss rel {rel:.3g} (tol {LARGE_LOSS_RTOL}), grad rel {g_rel:.3g} (tol "
            f"{LARGE_GRAD_RTOL}); peak memory of the step, n^2 * 4 B: fold-streamed "
            f"{peak_f / n2:.3f} (limit {PEAK_LIMIT_N2}), stacked {peak_s / n2:.3f}")
        assert rel <= LARGE_LOSS_RTOL and g_rel <= LARGE_GRAD_RTOL, (rule, rel, g_rel)
        assert peak_f <= PEAK_LIMIT_N2 * n2 and peak_f < peak_s, (rule, peak_f / n2, peak_s / n2)
    inverse = f64_inverse(x, y, p0)
    for rule in FOLD_RULES:
        v64, g64 = f64_step0(rule, x, y, p0, eps=eps, inverse=inverse)
        vf, gf = fused[rule]
        near = {k: (abs(float(v) - v64) / abs(v64),
                    {f: grad_rel({f: g[f]}, {f: g64[f]}) for f in g64})
                for k, v, g in (("fold-streamed", vf, gf), ("stacked", *stacked[rule]))}
        log(f"[folds] {rule} step 0 against float64 (loss {v64:.10g}, log-signal gradient "
            f"{float(g64['log_signal_sq']):.6g}, log-noise {float(g64['log_noise_sq']):.6g}): "
            + "; ".join(
            f"{k} loss rel {lr_:.3g}, grad rel by leaf "
            + ", ".join(f"{f_}: {e:.3g}" for f_, e in ge.items()) for k, (lr_, ge) in near.items())
            + f" (tol {LARGE_LOSS_RTOL}, {FOLD_F64_GRAD_RTOL} for fold-streamed)")
        lr_, ge = near["fold-streamed"]
        assert lr_ <= LARGE_LOSS_RTOL and all(e <= FOLD_F64_GRAD_RTOL[f_]
                                              for f_, e in ge.items()), (rule, lr_, ge)
    del inverse, fused, stacked
    torch.cuda.empty_cache()

    # 3. The counted run: 2 GD steps per rule; es draws from a CUDA generator.
    gram_cuda.reset_launches()
    fits, walls = {}, {}
    for rule in FOLD_RULES:
        sched = large_n.schedule_for(rule, n, LARGE_STEPS)
        loss = make_objective(rule, model="exact", fold_k=FOLD_K, num_sim=NUM_SIM)
        gen = torch.Generator(device=dev).manual_seed(ES_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits[rule] = fit_gd(loss, p0, x, y, LARGE_STEPS, sched.lr, generator=gen)
        torch.cuda.synchronize()
        walls[rule] = (time.perf_counter() - t0) / LARGE_STEPS
    launches = dict(gram_cuda.LAUNCHES)
    log(f"[folds] {len(FOLD_RULES)} rules x {LARGE_STEPS} steps, n = {n}, fold_k = {FOLD_K}: "
        f"kernel launches {launches}")
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched on the large_n fold path"
    for rule in FOLD_RULES:
        hist = fits[rule].loss_history.cpu()
        assert torch.isfinite(hist).all() and int(fits[rule].stall_iters) == 0, (rule, hist)

    # 4. Time, device time by kind, FLOP rate, memory; host syncs for dss.
    for rule in FOLD_RULES:
        loss = make_objective(rule, model="exact", fold_k=FOLD_K, num_sim=NUM_SIM)
        kw = {"eps": eps} if rule == "es" else {}
        m = bench_ceiling.measure_step(loss, p0, x, y, **kw)
        flop = bench_ceiling.step_flop(rule, n, FOLD_K)
        hist = fits[rule].loss_history.cpu()
        kinds = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in m["busy_by_kind"].items())
        line = (f"[folds-time] {rule}: loss {float(hist[0]):.6f} -> {float(hist[-1]):.6f}; wall "
                f"per GD step {walls[rule]:.4f} s; device busy {m['busy_s']:.4f} s of a profiled "
                f"value-and-grad (ms by kind: {kinds}), idle share {m['idle_share']:.4f}; "
                f"{flop / walls[rule] / 1e12:.2f} TFLOP/s ({flop:.3g} FLOP); peak memory "
                f"{m['peak_bytes'] / n2:.3f} n^2 * 4 B")
        if rule == "dss":
            sched = large_n.schedule_for(rule, n, 1)
            syncs = [w for w in host_syncs(lambda: fit_gd(loss, p0, x, y, 1, sched.lr))
                     if "set_sync_debug_mode" not in w]
            line += f"; host syncs in one GD step: {len(syncs)} {syncs}"
            assert not syncs, syncs
        assert m["peak_bytes"] <= PEAK_LIMIT_N2 * n2, (rule, m["peak_bytes"] / n2)
        log(line)
    del x, y, eps, fits
    torch.cuda.empty_cache()

    # 5. The large_n experiment on the fold rules at a cut size.
    argv = DRIVER_LARGE + ["--rules", *FOLD_RULES]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = large_n.main(argv + ["--device", str(dev)])
    for rule, rec in res.items():
        assert all(np.isfinite(rec[k]) for k in ("loss_first", "loss_last", *METRICS)), rec
    log(f"[folds-large_n] {' '.join(argv)}: {time.perf_counter() - t0:.2f} s; "
        + "; ".join(f"{r} s_per_iter_steady {rec['s_per_iter_steady']:.4f}, test crps "
                    f"{rec['crps']:.5f}" for r, rec in res.items()))
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"gpscore_torch {gpscore_torch.__version__}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {_build.library_path().name} loaded in {time.perf_counter() - t0:.2f} s")
    report = _build.build_report()
    log(report.rstrip())
    check_spills(report)
    err, times = phase_kernels(dev)
    launches = {"fitc": phase_slice(dev)}
    phase_pool(dev)
    launches["exact"] = phase_exact(dev)
    phase_drivers(dev)
    launches["large_n"] = phase_large_n(dev)
    launches["large_n_folds"] = phase_folds(dev)
    kernels = []
    for name, key in KERNELS:
        on_path = times[(name, *TIMED_SHAPES[0])]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": sum(c[key] for c in launches.values()),
                        "launches_by_path": {p: c[key] for p, c in launches.items()},
                        "max_abs_err": err[name], "ms": on_path["ms"],
                        "plain_ms": on_path["plain_ms"], "bound_ms": on_path["bound_ms"],
                        "bound_by": on_path["bound_by"], "library_ms": None,
                        "shapes": {"x".join(map(str, s)): times[(name, *s)]
                                   for s in TIMED_SHAPES + FWD_SHAPES
                                   if (name, *s) in times}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
