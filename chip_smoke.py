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
   (30720x2048x8), and all of K at the song set's width (30720x30720x90,
   phase 17's large-n step, K spanning a range); the sharded steps' backward shapes: 30720x30720x8 (the
   out-of-place stack at p = 1), 256x30720x8 and 256x7680x8 (a fused sharded
   step's streamed row block at p = 1 and 4), checked and timed (CUDA events)
   beside their bounds, and the fused sharded forward's f16 Gram panel
   256x30720x8 with its noise diagonal, bitwise the fp32 kernel's output
   rounded and within 1 ulp of plain. Then, at 500x20x8, 20x20x8, 500x500x8, 9700x20x8,
   120x120x1, 8192x8192x8 and 2048x30720x8, and for gram_fwd at
   30720x2048x8, kernel and plain times per call (CUDA events, back to back)
   and device time per call (torch.profiler's CUDA events, summed), and
   gram_fwd's time per call at 30720x30720x8 and 30720x30720x90 (CUDA events
   alone), beside the
   roofline bound (gram_cuda.roofline) and the share of it the kernel's time
   reaches (gpscore_torch/bench_gram.py does the timing). The d-chunked
   builds (past 64 floats, 32 doubles) at 500x500x65, 9700x20x130,
   9700x20x385, 2048x4096x90, 500x20x90, 20x20x90 and 2048x30720x90, each in fp32 and
   fp64, at 500x500x40 in fp64 and batched at 3x9700x20x130, and the float64
   builds at 500x20x8, 500x500x8 and 8192x8192x8: each kernel against its
   plain version (values and both gradients), a second call bitwise the
   first, K spanning a range at the d-chunked shapes; timed beside the bound
   (fp64: the card's 67 TFLOP/s fp64 rate, DMMA's), the batched one beside a loop of its
   launches; then parity_report --dtype float64 on the card, every 5e-9
   target.
4. The FITC slice: the five-rule KIN40K FITC-20 fit (n = 500, d = 8, m = 20)
   from the committed initial parameters, 25 GD steps per rule through fit_gd
   on CUDA (its default there: three eager steps, then 22 replays of the step
   captured in a CUDA graph), then the test-set evaluation. The kernels'
   launch counters are zeroed just before and read just after; they count the
   replays. At every step the loss and gradient on CUDA are held against the
   CPU's at the same parameters, the loop's update is checked, and a
   free-running CPU fit is compared with the CUDA one.
5. A real-size step: five crps steps on the full 9700-row pool (eager: under
   fit_gd's capture minimum).
6. The exact slice: the five kin40k_full rules (crps, nlml, logs, dss, es) on
   the exact GP at n = 500, d = 8, from init_rand_params on a seeded CPU
   generator, 25 GD steps each on CUDA on the kin40k_full schedules, replayed
   as in phase 4 (es draws from a CUDA generator registered with the graph),
   then the test-set evaluation; launch counters zeroed just before and read
   just after. The same checks as phase 4, es at fixed normals on both sides;
   then the eager loop's wall and device-busy time per step, and the host
   syncs of one eager GD step under torch.cuda.set_sync_debug_mode.
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
10. The fit as one device program (fit_gd's step replayed from a CUDA graph),
   at the bench's full width. (1) For the five FITC rules and the five exact
   rules (es from a seeded CUDA generator): a 200-step fit with graph=False
   and one with graph=True from the same start, with record_params; the loss
   history, every parameter history, the final parameters and stall_iters
   must be equal bit for bit; per rule the eager and the replayed wall time
   per step, and the device ops, device-busy time and idle share of a
   profiled replayed step. (2) A fit whose Cholesky fails from some step on,
   under replay: NaN losses, updates skipped, stall_iters counted, nothing
   raised, equal to the eager run. (3) The whole five-rule FITC-20 fit,
   14,000 iterations, replayed: wall-clock, microseconds per step, the Gram
   launches (2/2/2 a step, replays counted), the final losses, and the first
   500 steps of every rule eager for the ratio. (4) The host syncs of a
   whole replayed 50-step fit: none after the capture. (5) fit_optim with a
   capturable Adam, 200 steps replayed against eager, equal bit for bit.
   (6) A replayed fit after a larger Gram shape grew the workspace on
   another stream, a larger shape on the capture stream after the graph is
   gone, and a replayed fit again: all equal to eager.
11. The precision modes (gpscore_torch/utils/precision.py: "high" and "fast"
   as 3 and 1 TF32 passes, "bf16" and "f16" as 2-byte K_hat^-1 storage). (1)
   gram_fwd's 2-byte output at 30720x30720x8 (noise diagonal), 30720x2048x8
   and 500x500x8, bf16 and f16: bitwise the fp32 kernel's output rounded,
   within 1 ulp of the plain version, timed beside its 2-byte bound. (2) At
   n = 2048 and 2000 (block 512, fused threshold 1), crps, nlml, dss and es
   (fixed normals) on CUDA against the CPU's emulation of the same mode:
   "high" at phase 4's limits, the others at value rtol 2e-2 and gradient
   cosine > 0.999. (3) The 3 x TF32 product and one TF32 pass at 16384^3
   against float64, with their rates. (4) At n = 30,720 (phase 8's data,
   unit parameters), step 0 of crps, nlml and dss in every mode against
   float64 and "highest": "high" within "highest"'s float64 limits, and
   beside it crps and nlml in "high" with every product at 3 x TF32; "high",
   "fast" and "f16" finite (bf16 may come out NaN, and says so), peaks at most
   1.5 n^2 * 4 B ("high", "fast") and 0.45 under the rule's "highest" one
   (2-byte); wall per step, effective TFLOP/s, device time by kind, idle
   share, and for crps the host syncs of a GD step (none allowed). The
   launch counters are zeroed here and read after (8). (5) The in-place
   factor per mode against float64, and fit_gd_recovering from "bf16" for 3
   iterations of crps and dss: its recovery trail, no unrecovered iteration.
   (7) The large-n predictive of phase 8's crps fit at f16 storage, refine 0
   and 8, against float64 and the fp32 predictive (refine 8 within 1e-4 of
   float64). (8) The large_n experiment at n = 8192, --matmul bf16 and high,
   crps and dss. (6) A 200-step FITC crps fit under "high" and under "fast"
   (TF32 kernels in the graph), replayed == eager bit for bit. Phase 11 runs to its end and then fails on any failed check.
12. Restarts and replicates as one batched fit (the Gram kernels' batch grid
   axis, gpscore_torch/parallel/sweeps.py). (1) The three kernels batched, at
   16x500x20x8 and 16x20x20x8 (multi_restart's FITC K_fu and K_uu),
   10x500x500x8 (ten replicates' exact K_ff) and 3x20x8193x12 (a ragged batch
   whose row kernel takes column chunks), against their batched plain
   versions; a batch of one bitwise today's unbatched launch; every batch
   against its unbatched launch (bitwise where the plan tiles it alike); two
   calls bitwise equal; each timed beside a loop of B unbatched launches and
   the batched roofline bound. (2) restart_sweep of 16 FITC-20 restarts, crps
   and nlml, 200 steps: replayed == eager bit for bit; at the 16 solo fits'
   recorded parameters the batched loss (1e-4) and gradient (per leaf, phase
   4's 1e-3; the log-signal leaf 5e-2) against the solo ones and against a
   float64 witness on the CPU, where the batched and solo forms must agree
   to 1e-9. (3) multi_restart.main() at its defaults, launch counters zeroed
   just before and read just after (the "sweeps" path: two Gram launches a
   step for all 16 restarts), beside the same 16 crps restarts as solo fits.
   (4) kin40k_full --replicates 10, the replicates batched (the
   "sweeps_replicates" path), beside the per-replicate loop of fit_and_eval.
   (5) The host syncs of a batched replayed fit: none after the capture.
   (6) The replayed step at 1, 4, 16 and 64 restarts for FITC crps and nlml
   and exact crps: time, device ops, idle share, warm-up and capture.
13. The analysis suite (``gpscore_torch.analysis``, the ``analysis_figures``
   and ``parity_report`` drivers, pytree checkpoints): (1) the four objective
   surfaces at the driver's defaults (grid 50 x 50, n = 20) on CUDA against
   the port on the CPU on the same data (the same finite points, rtol 1e-3)
   and against it in float64 (5e-4), one gram_fwd launch a surface, timed; (2) the crps surface at n = 500:
   time, peak memory, and 16 sampled points against a float64 numpy LOO
   (tests/oracle.py); (3) a 300 x 300 grid (90,000 Grams, past the grid's z
   limit of 65,535): two gram_fwd launches, each point bitwise the same point
   of a grid of 45,000; a batched ArdGram forward and backward of B = 70,000
   at 20 x 5 x 1 (two launches a kernel) against the CPU's plain version; (4)
   the twelve sensitivity curves at the R grids on CUDA against the CPU at the
   same normals, then drawn from a CUDA generator, their minima at the truth;
   (5) ``analysis_figures.main(["--no-png", ...])`` end to end, the launch
   counters zeroed just before and read just after (the "analysis" path); (6)
   ``parity_report`` on the card in float32, every target passing; (7) the
   fit's FitResult with its parameter history through save_pytree /
   load_pytree onto the card, bitwise.
14. The mesh and the distributed dense stack (``gpscore_torch.parallel``) on
   one rank under NCCL (``init_distributed`` with a ``file://`` store, world
   size 1; the group destroyed at the end). With the launch counters zeroed
   just before and read just after (the "sharded" path): ``sharded_gram`` at
   30720x30720x8, bitwise ``gram_fwd`` (whose launch is left out of the
   count); ``sharded_restart_sweep`` at multi_restart's defaults (16 FITC-20
   crps restarts, 2000 iterations), bitwise ``restart_sweep``; the sharded
   LOO crps and k-fold dss steps at n = 30,720 (phase 8's data and
   parameters, block 256): time, peak in n^2 * 4 B (at most 6), loss and
   gradient against phase 8's and phase 9's float64 witnesses within their
   limits; ``sharded_cholesky``, ``sharded_tri_solve_lower`` and
   ``sharded_nlml`` at n = 8192 against float64; ``dryrun_multichip`` legs
   (1)-(12) on the one rank.
15. The fused sharded steps (``gpscore_torch.parallel``: the in-place
   sharded K_hat^-1, sharded_potri, and the streamed backward; the fold rules
   fold-streamed) on one NCCL rank at n = 30,720, d = 8 (phase 8's data and
   unit parameters), block 256: crps, logs, nlml, dss, kc and es (phase 9's
   fixed normals, 300 draws), the f16 crps and dss steps, and crps at block
   2048, each step built once and run twice through its entry point. Per
   step: the step-0 loss and gradient (1 - the lr-1 update) against the
   single-device fused or fold-streamed step and against phases 8 and 9's
   float64 witnesses (logs: its own) within those phases' limits (f16:
   finite, its peak 0.45 n^2 * 4 B under the fp32 step's, phase 11's 2-byte
   limit); the wall time of the second call; the peak of the first (at most
   1.5 n^2 * 4 B in fp32); for fp32 crps and dss the device time by kind and
   the idle share of a third, profiled call; the collectives the first issued
   (``parallel.mesh.COLLECTIVES``), whose bytes must equal
   ``bench_sharded.analytic_collective_bytes``. The launch counters are
   zeroed just before the steps and read just after (the "sharded_fused"
   path).
16. The RESULTS.md sweep tables (``gpscore_torch.experiments.results_parity``).
   (1) Phase 12 (1) at the tables' batched shapes (100x120x120x1,
   10x500x20x8, 10x20x20x8, 5x9700x256x8, 5x256x256x8), timed there. (2) ``results_parity.main(
   ["--quick", ...])``: simple_full's 100 replicates of crps, nlml and logs
   and kin40k_fitc's 10 of crps and nlml, each replicate from the JAX
   package's initial draw (and, for simple_full, its data), fitted on the
   card; every paired line against the committed JAX CPU fits and every
   ``[jax-eval]`` line must pass; the launch counters zeroed just before and
   read just after (the "results_parity" path); the paired deltas and the
   wall time logged.
17. Wide inputs, d = 90 (the song set's width), where the Gram backward runs
   its d-chunked kernels; the inputs' log lengths raised by log(d / 8) / 2
   (bench_wide.wide_params), and K's off-diagonal asserted to span a range.
   (a) The FITC-20 fit at n = 500, m = 20 (large_n's data), crps and nlml,
   25 steps of fit_gd's replayed step, the launch counters zeroed just
   before and read just after (the "wide" path); at every step CUDA against
   the CPU at the same parameters (phase 4's limits); the microseconds of a
   replayed crps step at d = 90 and d = 8 and the Gram kernels' device
   microseconds in it. (b) The exact GP's large-n step at n = 30,720 (the
   "wide_large_n" path): crps (fused LOO) and dss (fold-streamed), step 0
   against a float64 witness within phases 8 and 9's limits; the step's
   seconds, peak and device time by kind and the Gram backward's
   milliseconds (experiments/bench_wide.py).

The line before the last is the card's ``nvidia-smi`` name and power limit;
before it, one JSON line describes every kernel: ``ms``, ``plain_ms``,
``bound_ms`` and ``bound_by`` at the FITC path's 500x20x8 (``library_ms`` is
null: no single PyTorch call computes the ARD Gram or either half of its
VJP), ``launches`` summed over the FITC, exact, large-n, large-n fold, graph,
precision, two sweep, analysis, sharded, fused sharded, results_parity and two wide paths (each
path's count under
``launches_by_path``; a graph's replays are counted, gram_fwd's 2-byte
launches under gram_fwd), and
under ``shapes`` the per-call and device
times, the bound and the roofline share at every timed shape, with
``timed_by`` naming the source of the share's time (``torch.profiler``:
``device_ms``; ``cuda_events``: ``ms``, and no ``device_ms``); gram_fwd's
2-byte shapes end in ``/bf16`` or ``/f16``, the float64 ones in ``/f64``
(``500x500x8/f64``; their bound at the fp64 rate), the d-chunked ones are
keyed as the others (``500x500x65``), the batched ones (phases 12 and 16) are keyed
``BxNxMxD`` (``16x500x20x8``) and add ``loop_ms``, a loop of B unbatched
launches; phase 13's shapes (``2500x20x20x1``, ``90000x20x20x1``,
``70000x20x5x1``, ``2500x500x500x1``) have no loop (the batched d-chunked
``3x9700x20x130`` has one), and their surface
Grams, given one tensor as xs and xps, have x counted once in the bound
(``roofline(..., shared_x=True)``). The last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import importlib
import io
import json
import linecache
import os
import re
import sys
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

import gpscore_torch
from gpscore_torch import analysis, bench
from gpscore_torch.bench_gram import (CHUNK_SHAPES, F64_CHUNK_SHAPES, cuda_ms, device_ms,
                                     kernel_inputs, kernel_pairs, ms_text, nvidia_smi_line,
                                     time_shapes)
from gpscore_torch.data import kin40k_fitc20_init, kin40k_replicate_split, load_kin40k
from gpscore_torch.experiments import (analysis_figures, bench_ceiling, bench_sharded,
                                       bench_wide, common, kin40k_full, large_n, multi_restart,
                                       parity_report, results_parity)
from gpscore_torch.fit import (SCHEDULES, eval_predictive_metrics, fit_and_eval, fit_gd,
                               fit_gd_batch, fit_optim, make_objective, train)
from gpscore_torch.metrics import evaluate_predictive
from gpscore_torch.models import exact as exact_mod
from gpscore_torch.ops import _build, gram_cuda, linalg, loo_fused, potri_inplace
from gpscore_torch.ops.kernels import gram
from gpscore_torch.ops.loo_fused import auto_block
from gpscore_torch.parallel import (COLLECTIVES, add_noise_sharded, init_distributed, make_mesh,
                                    reset_collectives, restart_sweep, shard_rows,
                                    sharded_cholesky, sharded_gram, sharded_loo_value_and_grad,
                                    sharded_nlml, sharded_restart_sweep, sharded_tri_solve_lower)
from gpscore_torch.parallel.dryrun import dryrun_multichip
from gpscore_torch.scoring import rules
from gpscore_torch.utils import (batch_size, checkpoint, init_rand_params, init_unit_params,
                                 params_from_numpy, params_to_numpy, precision, select_params)

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
# and the evaluation's K(x, x*) for a chunk of 2048 test points; all of K at
# n = 30,720 and the song set's width (phase 17's large-n step).
FWD_SHAPES = [(30720, 30720, 8), (30720, 2048, 8), (30720, 30720, 90)]
# The sharded steps' backward: the out-of-place stack's (phase 14) cotangent
# of K(x_local, x) is [n/p, n], all of K at p = 1 and n = 30,720, a shape whose
# plans and chunks no other path gives the two backward kernels; the fused
# sharded steps' streamed backward (phase 15) gives them [b, n/p] blocks of
# a global row block against a rank's rows, b = 256: 256x30720x8 at p = 1,
# 256x7680x8 at p = 4 (n/b = 120 launches of each half a pass).
MESH_BWD_SHAPES = [(30720, 30720, 8), (256, 30720, 8), (256, 7680, 8)]
# The fused sharded forward's 2-byte Gram panel at p = 1: [b, n] rows of
# K_hat rounded once to f16, the noise on the panel's own diagonal.
MESH_FWD2_SHAPES = [(256, 30720, 8, True)]
# The d-chunked builds (d past 64 floats, 32 doubles), each checked in fp32
# and fp64 (bench_gram.CHUNK_SHAPES): 500x500x65 and 9700x20x130 (an exact
# K_ff and the pool's FITC K_fu just past a 64-feature chunk, and two chunks
# past), 9700x20x385 (the slice set's width on the full pool's FITC Gram),
# 2048x4096x90 and 2048x30720x90 (a large-n backward block at the song set's
# width, n = 4096 and 30,720), 500x20x90 and 20x20x90 (the FITC-20 K_fu and
# K_uu at that width); float64 also at 500x500x40 (F64_CHUNK_SHAPES); and
# batched, 3x9700x20x130. The fp32 ones are timed beside their bounds.
CHUNK_BATCHED = (3, 9700, 20, 130)
F64_SHAPES = [(500, 20, 8), (500, 500, 8), (8192, 8192, 8)]
# float64 kernel against its plain version (the cross-term form in float64,
# whose cancellation leaves ~1e-16 * |xs|^2): K and the backward.
F64_FWD_ATOL, F64_BWD_ATOL, F64_BWD_RTOL = 1e-12, 1e-11, 1e-11
KERNELS = [("gram_fwd", "fwd"), ("gram_bwd_rows", "bwd_rows"), ("gram_bwd_cols", "bwd_cols")]
# Per kernel, each unbatched and batched: gram_fwd's rows per thread times its
# three fp32 output types and its fp64 one, each unchunked and d-chunked; the
# backward's fp32 DMAX buckets (8, 16, 32, 64), its fp64 ones (8, 16, 32) and
# its d-chunked kernel in fp32 and fp64, each with its wide and its one-pair
# thread tile.
INSTANTIATIONS = {"gram_fwd": 64, "gram_bwd_rows": 22, "gram_bwd_cols": 22}
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
# Phase 10.
GRAPH_STEPS = 200  # the eager and the replayed fit that must be equal bit for bit
GRAPH_LONG = 1000  # replays of the fit that times the replayed step
GRAPH_EAGER_STEPS = 500  # the eager steps per rule beside the whole replayed fit
GRAPH_SYNC_STEPS = 50
# The eager loop's final losses of the 14,000-iteration fit on an NVIDIA H100
# 80GB HBM3 (``python -m gpscore_torch.bench --eager``; ROADMAP.md, queue 3
# item 3), beside which the replayed fit's are printed.
EAGER_FINAL_LOSS = {"crps": 0.208145, "nlml": 285.691650, "logs": 0.447697,
                    "dss": 222.006165, "kc": 0.832610}
# A Gram backward whose column kernel needs more scratch (5 chunks of 1031 x
# 64, 329,920 floats) than any shape of the fits before phase 10 (the largest:
# phase 7's two batched kin40k_full replicates, 2 x 8 chunks of 500 x 8).
GROW_SHAPE = (4099, 1031, 64)
# Phase 11.
PREC_MODES = ["high", "fast", "bf16", "f16"]  # the reduced modes; "highest" is phases 1-10's
PREC_SMALL_RULES = ["crps", "nlml", "dss", "es"]
PREC_LARGE_RULES = ["crps", "nlml", "dss"]
STORAGE = {"bf16": torch.bfloat16, "f16": torch.float16}
# The 2-byte Gram: the whole K_hat with its noise diagonal, the evaluation's
# K(x, x*) and the exact K_ff.
GRAM2_SHAPES = [(30720, 30720, 8, True), (30720, 2048, 8, False), (500, 500, 8, True)]
# The reduced modes against the CPU's emulation of the same mode at n = 2048
# and 2000: "high" at phase 4's limits; the one-pass and 2-byte modes, whose
# rounding the two sides take in other orders, at the JAX package's own
# limits for them (tests/test_potri_inplace.py:141-173): value rtol 2e-2,
# gradient cosine per leaf > 0.999.
PREC_RTOL, PREC_COS = 2e-2, 0.999
# The 3 x TF32 product against float64, relative to max (|A| |B|), at the JAX
# package's "high" grade: over the whole inner dimension it read 3.1e-6 at
# 16384^3, IEEE fp32 5.2e-7, one TF32 pass 2.1e-5 (NVIDIA H100 80GB HBM3,
# 700 W): the tensor cores' fp32 sum of a long chain, which the chunks of
# precision._SPLIT_K cut. Limit: 1e-6, and under one pass's.
TF32X3_GEMM, TF32X3_TOL = 16384, 1e-6
# Chunks of the inner dimension printed beside the package's precision._SPLIT_K
# (16384: one chain over the whole product).
TF32X3_CHUNKS = [16384, 4096, 1024, 512]
# A 2-byte step's peak, in n^2 * 4 B, at least this far under the same rule's
# "highest" one: the n x n buffer halves (0.5), 0.05 left for new transients.
PEAK_SAVE_N2 = 0.45
RECOVER_ITERS = 3  # fit_gd_recovering's iterations from "bf16" at n = 30,720
# Phase 12.
SWEEP_R = 16  # multi_restart's default restarts
# Batched kernel shapes (B, n, m, d): the multi-restart FITC-20 K_fu and K_uu,
# the ten replicates' exact K_ff, and a ragged batch whose row kernel takes
# column chunks (2 a row tile, tickets and scratch per batch; DMAX = 16).
SWEEP_SHAPES = [(16, 500, 20, 8), (16, 20, 20, 8), (10, 500, 500, 8), (3, 20, 8193, 12)]
SWEEP_SQUARE = [(20, 20), (500, 500)]  # K(u, u) and K(x, x): xps = xs
SWEEP_STEPS = 200  # the batched eager and replayed fits that must be equal bit for bit
SWEEP_CHECK_EVERY = 20  # steps of the solo fits at which the batched step is held to them
SWEEP_F64_EVERY = 40  # of those, the steps also held to a float64 witness on the CPU
# Per leaf, batched against solo and against float64, relative to the leaf's
# largest entry: phase 4's GRAD_RTOL, except the log-signal gradient of the
# random restarts, a sum of large terms that cancel (0.037 from terms of ~1
# for nlml), whose fp32 value reads up to 5.8e-3 (solo crps) and 1.7e-2
# (batched nlml) off float64 on the CPU at these points while the batched and
# the solo forms in float64 agree to 5e-12: fp32 rounding, no fault.
SWEEP_GRAD_RTOL = {"log_signal_sq": 5e-2}
SWEEP_REPLICATES = 10  # kin40k_full --replicates
SWEEP_STEP_CASES = [("fitc", "crps"), ("fitc", "nlml"), ("exact", "crps")]
SWEEP_STEP_RS = (1, 4, 16, 64)
SWEEP_LONG = 200  # replays of the fit that times the batched replayed step
SWEEP_PROFILED = 100  # replays of the profiled fit
# Phase 13.
SURFACE_RULES = ["nlml", "crps", "logs", "wrong_crps"]
GRID, N_CONTOUR, N_SURFACE_LARGE = 50, 20, 500  # the driver's defaults; the timed n
# A surface on CUDA against the port on the CPU, per finite point, relative.
# The CPU's plain Gram takes the cross-term form, whose cancellation at l =
# 0.2 (|x / l|^2 up to ~440) leaves the CPU's fp32 surfaces up to 4.5e-4 off
# a float64 evaluation (median 5e-8 to 9e-8); the CUDA kernel takes direct
# differences. So CUDA is held to the CPU at 1e-3 and to float64 (the port
# on the CPU in float64, the same data) at 5e-4.
SURFACE_RTOL, SURFACE_F64_SMALL_RTOL = 1e-3, 5e-4
# The crps surface at n = 500 against a float64 LOO at 16 sampled points,
# relative: fp32 read <= 6.2e-6 there on the CPU (K_hat's condition number
# up to 7e3).
SURFACE_F64_RTOL = 1e-4
BIG_GRID = 300  # 90,000 Grams: two chunks of the grid's z limit
BIG_BWD = (70000, 20, 5, 1)  # a batched backward past the limit: B, n, m, d
# A curve on CUDA against the CPU at the same normals, relative to the
# curve's largest magnitude (a relative change is ~0 at the truth).
CURVE_RTOL = 1e-5
ANALYSIS_OUT = "build/analysis_figures"  # gitignored, beside the kernel build
# Phase 16: the batched Grams of the sweep tables, (B, n, m, d): simple_full's
# 100 replicates' K_ff (n = 120, d = 1), kin40k_fitc's ten K_fu and K_uu, and
# the m = 256 full pool's five K_fu and K_uu (the largest FITC batch of the
# full run, which the quick run does not reach).
PARITY_SHAPES = [(100, 120, 120, 1), (10, 500, 20, 8), (10, 20, 20, 8), (5, 9700, 256, 8),
                 (5, 256, 256, 8)]
PARITY_SQUARE = [(120, 120), (20, 20), (256, 256)]
PARITY_OUT = "build/results_parity"
# Phase 14.
MESH_BLOCK = 256  # the sharded steps' panel width at n = 30,720
MESH_SMALL_N = 8192  # the Cholesky family against float64
MESH_PEAK_LIMIT_N2 = 6.0  # a sharded step's peak on one rank, in n^2 * 4 B
# The sharded factor and forward substitution against float64, relative to
# the largest entry (the in-place factor reads 4.9e-6, phase 8), and the
# NLML (JAX's own tolerance for the sharded NLML, tests/test_parallel.py).
MESH_FACTOR_RTOL, MESH_SOLVE_RTOL, MESH_NLML_RTOL = 1e-5, 1e-4, 2e-5
# Phase 8's crps and nlml and phase 9's dss, kc and es float64 step-0
# witnesses at n = 30,720, kept for phases 14 and 15's sharded steps on the
# same data and parameters.
F64_WITNESS = {}
# Phase 15.
FUSED_RULES = ["crps", "logs", "nlml", "dss", "kc", "es"]
FUSED_F16_RULES = ["crps", "dss"]
FUSED_WIDE_BLOCK = 2048  # the crps step timed once more at JAX's widest panel


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
        assert len(mine) == INSTANTIATIONS[name], (name, sorted(mine))
        assert all(v == (0, 0) for v in mine.values()), (name, mine)
    log("[build] ptxas: 0 spill bytes in every instantiation: "
        + ", ".join(f"{name} {INSTANTIATIONS[name]}" for name, _ in KERNELS))


def fwd_inputs(n, m, d, dev, seed):
    """xs [n, d] and xps [m, d] uniform in [-1, 1] (xps = xs when n == m, a
    K(x, x)) and sig = e, drawn on the card (a forward needs no cotangent);
    past d = 8 scaled by sqrt(8 / d), so that K spans a range as at d = 8."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.rand((n, d), generator=gen, device=dev) * 2.0 - 1.0
    if d > 8:
        xs = xs * (8 / d) ** 0.5
    xps = xs if n == m else torch.rand((m, d), generator=gen, device=dev) * 2.0 - 1.0
    return xs, xps, torch.tensor(np.e, dtype=torch.float32, device=dev)


def check_repair(dev, err):
    """The d-chunked kernels (fp32 and fp64, batched and not) and the float64
    ones against their plain versions (values and both gradients), a second
    call bitwise the first; K's off-diagonal spans a range at every d-chunked
    shape (the inputs' lengths are scaled with d, bench_gram.kernel_inputs)."""
    f32, f64_ = torch.float32, torch.float64
    cases = ([((1, *sh), dt) for sh in CHUNK_SHAPES for dt in (f32, f64_)]
             + [((1, *sh), f64_) for sh in F64_CHUNK_SHAPES]
             + [(CHUNK_BATCHED, dt) for dt in (f32, f64_)]
             + [((1, *sh), f64_) for sh in F64_SHAPES])
    for s, ((B, n, m, d), dt) in enumerate(cases):
        if B == 1:
            xs, xps, sig, g = kernel_inputs(n, m, d, dev, seed=200 + s, dtype=dt)
        else:
            xs, xps, sig, g = batched_kernel_inputs(B, n, m, d, dev, seed=200 + s, dtype=dt)
        f64 = dt == torch.float64
        chunked = d > gram_cuda.max_unchunked_d(xs.element_size())
        f_tol, b_atol, b_rtol = ((F64_FWD_ATOL, F64_BWD_ATOL, F64_BWD_RTOL) if f64
                                 else (FWD_ATOL, BWD_ATOL, BWD_RTOL))
        calls = kernel_calls().values()
        got, again, want = ([o for pair in calls for o in pair[i](xs, xps, sig, g)]
                            for i in (0, 0, 1))
        assert all(a.dtype == dt for a in got), (n, m, d, [a.dtype for a in got])
        assert all(torch.equal(a, b) for a, b in zip(got, again)), (n, m, d, dt, "second call")
        span = ""
        if chunked:  # W is not zero off a diagonal: the comparisons below are not vacuous
            lo, hi = float(got[0].min()), float(got[0].max())
            assert lo < 0.5 * hi, (n, m, d, lo, hi)
            span = f"; K spans {lo:.3g} to {hi:.3g}"
        errs = {}
        for name, a, b in zip(("K", "d_xs", "rowsum", "d_xps"), got, want):
            e = float((a - b).abs().max())
            tol = f_tol if name == "K" else b_atol + b_rtol * float(b.abs().max())
            assert torch.isfinite(a).all() and e <= tol, (n, m, d, dt, name, e, tol)
            errs[name] = e
        torch.cuda.synchronize()
        if not f64:  # the fp32 error columns of the kernels line
            err["gram_fwd"] = max(err["gram_fwd"], errs["K"])
            err["gram_bwd_rows"] = max(err["gram_bwd_rows"], errs["d_xs"], errs["rowsum"])
            err["gram_bwd_cols"] = max(err["gram_bwd_cols"], errs["d_xps"])
        del got, again, want, xs, xps, g
        torch.cuda.empty_cache()
        log(f"[repair] {'' if B == 1 else f'{B}x'}{n}x{m}x{d} {str(dt)[6:]}"
            f"{' (d-chunked)' if chunked else ''}: "
            + ", ".join(f"{k} err {v:.3g}" for k, v in errs.items())
            + f" (tol {f_tol}; {b_atol} + {b_rtol} * max|ref|); second call bitwise equal"
            + span)
    with contextlib.redirect_stdout(io.StringIO()) as buf, \
            contextlib.redirect_stderr(io.StringIO()):
        rc = parity_report.main(["--dtype", "float64"])
    report = json.loads(buf.getvalue())
    assert rc == 0 and all(r["pass"] and r["target"] == 5e-9 for r in report.values()), report
    errs = {k: next(v for f, v in r.items() if f.startswith("max_")) for k, r in report.items()}
    log("[repair] parity_report --dtype float64 on the card (the Gram through the float64 "
        "kernel), every 5e-9 target passes: "
        + ", ".join(f"{k} {errs[k]:.2g}" for k in sorted(report)))


def phase_kernels(dev):
    err = {k: 0.0 for k in REPLACES}
    check_repair(dev, err)
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
        if d > 8:  # not an identity: the comparison is not vacuous
            assert float(K.min()) < 0.5 * float(K.max()), (n, m, d)
        del K
        err["gram_fwd"] = max(err["gram_fwd"], e_f)
        log(f"[kernels] {n}x{m}x{d} (gram_fwd alone{', K(x, x)' if n == m else ''}): fwd err "
            f"{e_f:.3g} (tol {FWD_ATOL})"
            + ("; exactly symmetric with an exact diagonal" if n == m else ""))
    # Each entry's device_ms is torch.profiler's; at 30720^2 the profiler's
    # windows lost that kernel's events (three in a row), so there the time is
    # CUDA events alone: a call is milliseconds of one kernel, under which the
    # wrapper's host time hides, and the roofline share is taken of "ms".
    times = time_shapes(TIMED_SHAPES + CHUNK_SHAPES, dev, log=log)
    times.update(time_shapes(F64_SHAPES + F64_CHUNK_SHAPES, dev, log=log, dtype=torch.float64))
    times.update(time_shapes([s for s in FWD_SHAPES if s[0] != s[1]], dev,
                             names=("gram_fwd",), log=log))
    for t in times.values():
        t["timed_by"] = "torch.profiler"
        if t["device_ms"] is None:  # the profiler lost the events: CUDA events alone
            del t["device_ms"], t["plain_device_ms"]
            t["timed_by"] = "cuda_events"
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
    for s, (n, m, d) in enumerate(MESH_BWD_SHAPES):
        xs, xps, sig = fwd_inputs(n, m, d, dev, seed=300 + s)
        g = torch.randn((n, m), generator=torch.Generator(device=dev).manual_seed(300 + s),
                        device=dev)
        pairs = kernel_pairs(xs, xps, sig, g)
        errs = {}
        for name in ("gram_bwd_rows", "gram_bwd_cols"):
            kern, plain = pairs[name]
            got, again, want = ((r if isinstance(r, tuple) else (r,)) for r in (kern(), kern(),
                                                                                 plain()))
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (n, m, d, name)
            for part, a, b in zip(("d_xs", "rowsum") if len(got) == 2 else ("d_xps",), got,
                                  want):
                e = float((a - b).abs().max())
                tol = BWD_ATOL + BWD_RTOL * float(b.abs().max())
                assert torch.isfinite(a).all() and e <= tol, (n, m, d, part, e, tol)
                errs[part] = e
                err[name] = max(err[name], e)
            del got, again, want
            p1, k1, k2, p2 = (cuda_ms(f, reps=r, warmup=2) for f, r in
                              ((plain, 5), (kern, 20), (kern, 20), (plain, 5)))
            times[(name, n, m, d)] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                                      "timed_by": "cuda_events"}
        del xs, xps, g, pairs
        torch.cuda.empty_cache()
        role = ("the out-of-place sharded steps' backward at p = 1" if n == m else
                f"a fused sharded step's backward block at p = {30720 // m}")
        log(f"[kernels] {n}x{m}x{d} ({role}): bwd err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tol {BWD_ATOL} + {BWD_RTOL} * max|ref|); second call bitwise equal; per call "
            + ", ".join(f"{k} {times[(k, n, m, d)]['ms']:.4f} ms (plain "
                        f"{times[(k, n, m, d)]['plain_ms']:.4f})"
                        for k in ("gram_bwd_rows", "gram_bwd_cols"))
            + " (CUDA events, back to back)")
    phase_gram2(dev, times, MESH_FWD2_SHAPES, {"f16": torch.float16}, tag="kernels")
    # The batched d-chunked backward beside a loop of B unbatched launches.
    B, n, m, d = CHUNK_BATCHED
    xs, xps, sig, g = batched_kernel_inputs(B, n, m, d, dev, seed=400)
    for name, (kern, plain) in list(kernel_calls().items())[1:]:
        t, _ = time_kernel(name, lambda: kern(xs, xps, sig, g), lambda: plain(xs, xps, sig, g),
                           CHUNK_BATCHED, reps=20, warmup=3,
                           loop=lambda: [kern(xs[b], xps[b], sig[b], g[b]) for b in range(B)])
        times[(name, *CHUNK_BATCHED, "batched")] = t
        log(f"[kernels] {name} {B}x{n}x{m}x{d} (batched, d-chunked): per call "
            f"{t['ms']:.4f} ms, a loop of {B} launches {t['loop_ms']:.4f}, plain "
            f"{t['plain_ms']:.4f}; device {ms_text(t.get('device_ms'))}; bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), share {t['roofline_share']:.3f}")
    del xs, xps, g
    for (name, n, m, d, *kind), t in times.items():
        if kind and kind[-1] == "batched":  # its bound is time_kernel's
            continue
        if kind and kind[0] != "f64":  # a 2-byte gram_fwd: its bound is phase_gram2's
            continue
        bound = gram_cuda.roofline(name, n, m, d, elem=8 if kind else 4)
        t.update(bound_ms=bound.bound_us / 1e3, bound_by=bound.bound_by,
                 roofline_share=bound.bound_us / 1e3 / t.get("device_ms", t["ms"]))
        log(f"[bound] {name} {n}x{m}x{d}{'/' + kind[0] if kind else ''}: {bound.bytes} bytes, "
            f"{bound.flops} FLOP: "
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


@contextlib.contextmanager
def sync_warnings():
    """Inside the block torch.cuda's sync debug mode warns of every
    synchronizing CUDA call; yields the list the warnings land in."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")


def sync_sites(caught):
    """One "file:line: source" per synchronizing call among the warnings."""
    return [f"{w.filename}:{w.lineno}: {linecache.getline(w.filename, w.lineno).strip()}"
            for w in caught if "synchroniz" in str(w.message)]


def host_syncs(fn):
    """Where ``fn`` makes a synchronizing CUDA call."""
    with sync_warnings() as caught:
        fn()
    return sync_sites(caught)


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
    # The eager loop's time per step, warm, outside the counted run: three
    # 25-step fits per rule (host clock, synchronized), device-busy time over
    # 5 steps, and the host syncs of one step. Phase 10 times the replayed one.
    for rule in EXACT_RULES:
        sched = SCHEDULES[("kin40k_full", rule)]
        loss_fn = make_objective(rule, model="exact")
        p0 = exact_init(rule, dev)
        gen = torch.Generator(device=dev).manual_seed(ES_SEED)

        def fit(steps):
            return fit_gd(loss_fn, p0, gpu.train_x, gpu.train_y, steps, sched.lr, generator=gen,
                          graph=False)

        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fit(SMOKE_STEPS)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) / SMOKE_STEPS * 1e3)
        busy, n_ops = device_ms(lambda: fit(5), reps=1, warmup=1)
        syncs = [host_syncs(lambda: fit(1)) for _ in range(2)]
        dev_text = ("device busy not measured" if busy is None else
                    f"device busy {busy / 5:.4f} ms and {n_ops / 5:.0f} device ops per step")
        log(f"[exact-time] {rule}, eager: wall per step " + ", ".join(f"{w:.3f}" for w in walls)
            + f" ms (three {SMOKE_STEPS}-step fits); {dev_text}; host syncs in one GD step, twice: "
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
    """The d per-dimension squared differences [n, m] of rows of a and b, one
    at a time (at d = 90 all of them at once would be 45 GB a row block)."""
    return ((a[:, k, None] - b[None, :, k]) ** 2 for k in range(a.shape[1]))


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
    crps and logs, through a = K^-1 y and diag(K^-1): G = -(K^-1 a_bar) a^T -
    K^-1 diag(d_bar) K^-1. A fold rule (dss, kc, es at the normals ``eps`` =
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
    elif rule in ("crps", "logs"):  # on the LOO predictive
        score = rules.crps_gaussian if rule == "crps" else rules.logs_gaussian
        a_, d_ = a.clone().requires_grad_(), Kinv.diagonal().clone().requires_grad_()
        loss = score(y64 - a_ / d_, 1.0 / d_, y64)
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
        rows = xs[r0:r0 + F64_ROWS]
        C = G * (sig * torch.exp(-0.5 * sum(f64_sqdist(rows, xs))))
        sig_bar += C.sum()
        len_bar += torch.stack([(C * dk).sum() for dk in f64_sqdist(rows, xs)])
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
        F64_WITNESS[rule] = (v64, g64)
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
    return launches, p


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
        F64_WITNESS[rule] = (v64, g64)
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


def bits_equal(a, b):
    """Equal bit for bit, NaNs included (``torch.equal`` calls no NaN equal);
    two Nones are equal."""
    if a is None or b is None:
        return a is b
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def fits_equal(a, b, steps=None):
    """The fields of FitResult ``a`` that differ from ``b``'s bit for bit:
    the loss history, every parameter history (both up to ``steps``), and,
    with ``steps`` None, the final parameters and stall_iters."""
    cut = slice(None, steps)
    pairs = [("loss_history", a.loss_history[cut], b.loss_history[cut])]
    if a.param_history is not None:
        pairs += [(f"param_history.{f}", t[cut], b.param_history.leaves()[f][cut])
                  for f, t in a.param_history.leaves().items()]
    if steps is None:
        pairs += [(f"params.{f}", t, b.params.leaves()[f]) for f, t in a.params.leaves().items()]
        pairs.append(("stall_iters", a.stall_iters, b.stall_iters))
    return [name for name, u, v in pairs if not bits_equal(u, v)]


def first_parting(a, b):
    """The first step whose loss differs bit for bit, or None."""
    differ = (a.loss_history.view(torch.int32) != b.loss_history.view(torch.int32)).nonzero()
    return int(differ[0]) if len(differ) else None


def failing_below(loss_fn, threshold):
    """``loss_fn`` plus the half log-det of a 2 x 2 matrix that stops being
    positive definite once the loss is under ``threshold``: from that step on
    the Cholesky fails on the device, the loss is NaN, the update is skipped,
    and so it fails at every later step too. Nothing here looks at a value on
    the host, so the step can be captured."""
    def loss(params, x, y, generator=None):
        value = loss_fn(params, x, y, generator)
        bad = torch.eye(2, device=x.device) * (value.detach() - threshold)
        return value + 0.0 * linalg.half_logdet(linalg.chol_factor(bad))
    return loss


def phase_graph(dev):
    data = load_kin40k()
    gpu = kin40k_replicate_split(data, 0, device=dev)
    x, y = gpu.train_x, gpu.train_y
    p_fitc = kin40k_fitc20_init(dev)

    def case(model, rule):
        """(loss, initial parameters, lr, lr_inducing, generator factory)."""
        if model == "fitc":
            sched, p0 = SCHEDULES[("kin40k_fitc", rule)], p_fitc
        else:
            sched, p0 = SCHEDULES[("kin40k_full", rule)], exact_init(rule, dev)
        gen = (lambda: torch.Generator(device=dev).manual_seed(ES_SEED)) if rule == "es" \
            else (lambda: None)
        return make_objective(rule, model=model), p0, sched.lr, sched.lr_inducing, gen

    def timed_fit(fit):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # 1. Replayed against eager, bit for bit, all ten rules; time and profile.
    eager_crps = None
    for model, rule in [("fitc", r) for r in RULES] + [("exact", r) for r in EXACT_RULES]:
        loss, p0, lr, lr_u, gen = case(model, rule)

        def fit(iters, graph, record=False):
            return fit_gd(loss, p0, x, y, iters, lr, lr_u, generator=gen(),
                          record_params=record, graph=graph)

        fit(train.GRAPH_WARMUP, False)  # warm: the rule's kernels and handles
        eager, eager_s = timed_fit(lambda: fit(GRAPH_STEPS, False, True))
        replayed, replayed_s = timed_fit(lambda: fit(GRAPH_STEPS, True, True))
        differ = fits_equal(replayed, eager)
        assert not differ, (model, rule, differ, "first parting step",
                            first_parting(replayed, eager))
        assert torch.isfinite(eager.loss_history).all() and int(replayed.stall_iters) == 0
        # The replay alone: a long replayed fit less the shortest one (warm-up,
        # capture and one replay; the fastest of five, as is the warm-up
        # alone, whose difference is the capture's cost).
        warm = train.GRAPH_WARMUP
        short_s = min(timed_fit(lambda: fit(warm + 1, True))[1] for _ in range(5))
        warm_s = min(timed_fit(lambda: fit(warm, False))[1] for _ in range(5))
        _, long_s = timed_fit(lambda: fit(warm + 1 + GRAPH_LONG, True))
        step_us = (long_s - short_s) / GRAPH_LONG * 1e6
        eager_us = eager_s / GRAPH_STEPS * 1e6
        ops, busy_us = bench.profile_replayed(lambda iters: fit(iters, True))
        log(f"[graph] {model} {rule}: {GRAPH_STEPS} steps replayed == eager bit for bit (loss "
            f"and parameter histories, final parameters, stall_iters), loss "
            f"{float(eager.loss_history[0]):.6f} -> {float(eager.loss_history[-1]):.6f}; per "
            f"step eager {eager_us:.1f} us, replayed {step_us:.1f} us ({eager_us / step_us:.2f}x"
            f") over {GRAPH_LONG} replays; capture {(short_s - warm_s) * 1e3 - step_us / 1e3:.2f} "
            f"ms beside {warm} eager steps of {warm_s / warm * 1e3:.2f} ms; the {GRAPH_STEPS}-step "
            f"replayed fit, all in, {replayed_s * 1e3:.1f} ms (eager {eager_s * 1e3:.1f}); a "
            f"replayed step under the profiler: {ops:.1f} device ops, busy {busy_us:.1f} us; "
            f"idle share replayed {1 - busy_us / step_us:.3f}, eager {1 - busy_us / eager_us:.3f} "
            f"(the same device time over the eager step)")
        if (model, rule) == ("fitc", "crps"):
            eager_crps = eager

    # 2. A Cholesky that fails from some step on, under replay.
    loss, p0, lr, lr_u, gen = case("fitc", "crps")
    hist = eager_crps.loss_history
    threshold = float(0.5 * (hist[0] + hist.min()))
    failing = failing_below(loss, threshold)
    runs = [fit_gd(failing, p0, x, y, GRAPH_STEPS, lr, lr_u, record_params=True, graph=g)
            for g in (False, True)]
    differ = fits_equal(runs[1], runs[0])
    nan = torch.isnan(runs[1].loss_history)
    first = int(nan.nonzero()[0])
    assert not differ, (differ, first_parting(runs[1], runs[0]))
    assert train.GRAPH_WARMUP < first < GRAPH_STEPS - 1, first  # it fails under replay
    assert nan[first:].all() and not nan[:first].any()
    assert int(runs[1].stall_iters) == GRAPH_STEPS - first
    for f, t in runs[1].params.leaves().items():  # frozen at the last good point
        assert torch.equal(t, runs[1].param_history.leaves()[f][first]), f
    log(f"[graph] failed Cholesky under replay (crps loss under {threshold:.4f}): NaN from step "
        f"{first} on, updates skipped, stall_iters {int(runs[1].stall_iters)}, no raise; equal "
        f"to the eager run bit for bit")

    # 3. The whole five-rule fit, replayed; the same first steps eager.
    gram_cuda.reset_launches()
    (fits, seconds), wall = timed_fit(lambda: bench.fit_all(p_fitc, x, y))
    launches = dict(gram_cuda.LAUNCHES)
    total = sum(len(r.loss_history) for r in fits.values())
    assert launches == {k: 2 * total for k in launches}, (launches, total)
    (_, eager_seconds), eager_wall = timed_fit(
        lambda: bench.fit_all(p_fitc, x, y, iters=GRAPH_EAGER_STEPS, graph=False))
    log(f"[graph] five-rule FITC-20 fit, {total} iterations replayed ({total} - "
        f"{train.GRAPH_WARMUP * len(RULES)} replays): {wall:.3f} s; kernel launches {launches}; "
        f"the first {GRAPH_EAGER_STEPS} steps of every rule eager: {eager_wall:.3f} s")
    for rule, res in fits.items():
        h = res.loss_history
        assert torch.isfinite(h).all() and int(res.stall_iters) == 0, rule
        step_us = seconds[rule] / len(h) * 1e6
        eager_us = eager_seconds[rule] / GRAPH_EAGER_STEPS * 1e6
        was = EAGER_FINAL_LOSS[rule]
        log(f"[graph] {rule}: {len(h)} iterations in {seconds[rule]:.3f} s, {step_us:.1f} us "
            f"per step (eager {eager_us:.1f}, {eager_us / step_us:.2f}x); final loss "
            f"{float(h[-1]):.6f}, the eager loop's on record {was:.6f} (rel "
            f"{abs(float(h[-1]) - was) / abs(was):.2g}); stall_iters 0")

    # 4. Host syncs of a whole replayed fit: none once the step is captured.
    marks = []
    with sync_warnings() as caught:
        def marking(params, xx, yy, generator=None):
            marks.append(len(sync_sites(caught)))
            return loss(params, xx, yy, generator)

        fit_gd(marking, p0, x, y, GRAPH_SYNC_STEPS, lr, lr_u, graph=True)
    sites = sync_sites(caught)
    assert len(marks) == train.GRAPH_WARMUP + 1, marks  # the loss ran in Python 4 times
    after = sites[marks[-1]:]
    log(f"[graph] host syncs of a replayed {GRAPH_SYNC_STEPS}-step fit: {marks[-1]} before the "
        f"captured step ({sorted(set(sites[:marks[-1]]))}), {len(after)} from the captured "
        f"step to the return {after}")
    assert not after, after

    # 5. fit_optim with a capturable Adam.
    def adam(leaves):
        return torch.optim.Adam(leaves, lr=1e-2, capturable=True)

    runs = [fit_optim(loss, p0, x, y, GRAPH_STEPS, adam, graph=g) for g in (False, True)]
    differ = fits_equal(runs[1], runs[0])
    h = runs[1].loss_history
    assert not differ and torch.isfinite(h).all() and float(h[-1]) < float(h[0]), (differ, h)
    log(f"[graph] fit_optim, Adam (lr 1e-2, capturable), {GRAPH_STEPS} steps replayed == eager "
        f"bit for bit; crps loss {float(h[0]):.6f} -> {float(h[-1]):.6f}")

    # 6. The Gram backward's workspace around a graph's life.
    # The current stream's has held this shape's scratch since phase 3; the
    # capture stream's has only ever seen the fits' shapes.
    big = kernel_inputs(*GROW_SHAPE, dev, seed=0)
    want = gram_cuda.gram_bwd_cuda(*big)
    again = fit_gd(loss, p0, x, y, GRAPH_SYNC_STEPS, lr, lr_u, record_params=True, graph=True)
    differ = fits_equal(again, eager_crps, GRAPH_SYNC_STEPS)
    assert not differ, ("beside a larger workspace on another stream", differ)
    side = train._capture_stream(dev)
    held = gram_cuda._WORKSPACES[(dev, side.cuda_stream, torch.float32)]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # replaces the capture stream's workspace, the graph gone
        got = gram_cuda.gram_bwd_cuda(*big)
    torch.cuda.current_stream().wait_stream(side)
    grown = gram_cuda._WORKSPACES[(dev, side.cuda_stream, torch.float32)]
    assert grown[1].numel() > held[1].numel(), (grown[1].numel(), held[1].numel())
    del held
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "capture stream's workspace"
    again = fit_gd(loss, p0, x, y, GRAPH_SYNC_STEPS, lr, lr_u, record_params=True, graph=True)
    differ = fits_equal(again, eager_crps, GRAPH_SYNC_STEPS)
    assert not differ, ("after growth on the capture stream", differ)
    log(f"[graph] workspace: a replayed fit beside the current stream's larger workspace, a "
        f"{'x'.join(map(str, GROW_SHAPE))} backward that replaces the capture stream's "
        f"({grown[1].numel()} scratch floats) once the graph is gone, and a replayed fit again: "
        f"all equal to eager bit for bit")
    return launches


PREC_FAILED = []  # phase 11's failed checks: it runs to its end, then fails on any


def check(ok, *what):
    """A check of phase 11: logged and kept when it fails."""
    if not ok:
        PREC_FAILED.append(what)
        log(f"[precision] CHECK FAILED: {what}")


def storage_ulps(got, want_fp32, st):
    """The largest |got - want| in units of the storage dtype's spacing at
    want (subnormals' spacing below its smallest normal)."""
    info = torch.finfo(st)
    w = want_fp32.float()
    spacing = torch.clamp(torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(info.tiny)))),
                          min=info.tiny) * info.eps
    return float(((got.float() - w).abs() / spacing).max())


def cosines(got, want):
    """{leaf: cosine of the two gradients} (a scalar leaf: the sign)."""
    out = {}
    for f in want:
        g, w = got[f].double().cpu().reshape(-1), want[f].double().cpu().reshape(-1)
        out[f] = float(g @ w / (g.norm() * w.norm()).clamp_min(1e-300))
    return out


def phase_gram2(dev, times, shapes=GRAM2_SHAPES, storage=STORAGE, tag="precision"):
    """Phase 11.1 (and phase 3's sharded panel): the 2-byte gram_fwd against
    the fp32 kernel rounded, its plain version, and its bound; the times
    land in ``times``."""
    for n, m, d, diag in shapes:
        xs, xps, sig = fwd_inputs(n, m, d, dev, seed=7)
        noise = torch.tensor(0.37, device=dev) if diag else None
        K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
        if diag:
            K.diagonal().add_(noise)
        for name, st in storage.items():
            K2 = gram_cuda.gram_fwd_cuda(xs, xps, sig, out_dtype=st, diag_add=noise)
            again = gram_cuda.gram_fwd_cuda(xs, xps, sig, out_dtype=st, diag_add=noise)
            assert K2.dtype == st and torch.equal(K2, K.to(st)), (n, m, d, name, "not bitwise")
            assert torch.equal(K2, again), (n, m, d, name, "two calls differ")
            ulps = storage_ulps(K2, gram_cuda.gram_fwd_plain(xs, xps, sig, torch.float32, noise)
                                .to(st), st)
            assert ulps <= 1.0, (n, m, d, name, ulps)

            def kern():
                return gram_cuda.gram_fwd_cuda(xs, xps, sig, out_dtype=st, diag_add=noise)

            def plain():
                return gram_cuda.gram_fwd_plain(xs, xps, sig, st, noise)

            reps = 50 if n * m > 1e8 else 200
            p1, k1, k2, p2 = (cuda_ms(f, reps=r, warmup=2) for f, r in
                              ((plain, max(5, reps // 10)), (kern, reps), (kern, reps),
                               (plain, max(5, reps // 10))))
            bound = gram_cuda.roofline("gram_fwd", n, m, d, out_bytes=2, diag=diag)
            t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "timed_by": "cuda_events",
                 "dtype": name, "bound_ms": bound.bound_us / 1e3, "bound_by": bound.bound_by}
            t["roofline_share"] = t["bound_ms"] / t["ms"]
            times[("gram_fwd", n, m, d, name)] = t
            log(f"[{tag}] gram_fwd {n}x{m}x{d} -> {name}{' + noise diagonal' if diag else ''}"
                f": bitwise the fp32 kernel's output rounded, {ulps:.3g} ulp of the plain version "
                f"(limit 1); per call kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms "
                f"(CUDA events); bound {bound.bytes} bytes, {t['bound_ms']:.5f} ms by "
                f"{bound.bound_by}, reached {t['roofline_share']:.3f}")
        del K, K2, again
        torch.cuda.empty_cache()


def phase_precision_small(dev):
    """Phase 11.2: each reduced mode on CUDA against the CPU's emulation of
    the same mode, at n = 2048 and 2000 (block 512, fused threshold 1)."""
    vg = bench_ceiling.value_and_grad
    for n, block in SMALL_LARGE:
        x, y, _, _ = large_n.make_data(n, LARGE_D, 0)
        p_cpu = init_unit_params(LARGE_D, isotropic=False)
        p_gpu = init_unit_params(LARGE_D, isotropic=False, device=dev)
        eps_cpu = fold_eps(n, "cpu")
        eps_gpu = tuple(e.to(dev) for e in eps_cpu)
        for mode in PREC_MODES:
            worst = {"loss": 0.0, "grad": 0.0, "cos": 1.0}
            with fused_from(1), precision.matmul_mode(mode):
                for rule in PREC_SMALL_RULES:
                    loss = make_objective(rule, model="exact", fold_k=FOLD_K, num_sim=NUM_SIM,
                                          block=block)
                    es = rule == "es"
                    lg, gg = vg(loss, p_gpu, x.to(dev), y.to(dev), **({"eps": eps_gpu} if es else {}))
                    lc, gc = vg(loss, p_cpu, x, y, **({"eps": eps_cpu} if es else {}))
                    rel = abs(float(lg) - float(lc)) / abs(float(lc))
                    worst["loss"] = max(worst["loss"], rel)
                    worst["grad"] = max(worst["grad"], grad_rel(gg, gc))
                    worst["cos"] = min(worst["cos"], *cosines(gg, gc).values())
            log(f"[precision] n = {n}, block {block}, {mode}, fused {'/'.join(PREC_SMALL_RULES)}: "
                f"CPU (emulated) vs CUDA loss rel {worst['loss']:.3g}, grad rel {worst['grad']:.3g}"
                f", least gradient cosine {worst['cos']:.7f}")
            if mode == "high":
                check(worst["loss"] <= LOSS_RTOL and worst["grad"] <= GRAD_RTOL, n, mode, worst)
            else:
                check(worst["loss"] <= PREC_RTOL and worst["cos"] > PREC_COS, n, mode, worst)


def phase_tf32_gemm(dev):
    """Phase 11.3: the 3 x TF32 product and one TF32 pass at 16384^3 against
    float64, with their rates."""
    n = TF32X3_GEMM
    gen = torch.Generator(device=dev).manual_seed(11)
    A = torch.randn((n, n), generator=gen, device=dev)
    B = torch.randn((n, n), generator=gen, device=dev)
    want = A.double() @ B.double()
    scale = float((A.double().abs() @ B.double().abs()).max())
    out = {}
    for mode in ("highest", "high", "fast"):
        with precision.matmul_mode(mode):
            C = precision.matmul(A, B)
            ms = cuda_ms(lambda: precision.matmul(A, B), reps=3, warmup=1)
        out[mode] = (float((C.double() - want).abs().max()) / scale, ms)
        del C
    assert not torch.backends.cuda.matmul.allow_tf32
    log(f"[precision] {n}^3 GEMM against float64, max error over max(|A| |B|): "
        + "; ".join(f"{m} {e:.3g} in {ms:.2f} ms ({2.0 * n ** 3 / ms / 1e9:.1f} TFLOP/s)"
                    for m, (e, ms) in out.items())
        + f" (highest: IEEE fp32; high: 3 x TF32 in chunks of {precision._SPLIT_K} of the inner"
        f" dimension, limit {TF32X3_TOL}; fast: one TF32 pass)")
    check(out["high"][0] <= TF32X3_TOL and out["high"][0] < out["fast"][0], "3 x TF32 GEMM", out)
    chunks, kept = {}, precision._SPLIT_K
    try:
        for k in TF32X3_CHUNKS:
            precision._SPLIT_K = k
            with precision.matmul_mode("high"):
                C = precision.matmul(A, B)
                ms = cuda_ms(lambda: precision.matmul(A, B), reps=3, warmup=1)
            chunks[k] = (float((C.double() - want).abs().max()) / scale, ms)
            del C
    finally:
        precision._SPLIT_K = kept
    log(f"[precision] 3 x TF32 at {n}^3 by chunk of the inner dimension (the package's: {kept}), "
        "error over max(|A| |B|) and rate: "
        + "; ".join(f"{k} {e:.3g} ({2.0 * n ** 3 / ms / 1e9:.1f} TFLOP/s)"
                    for k, (e, ms) in chunks.items()))
    del A, B, want
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def every_product_tf32x3():
    """Inside the block "high" splits every non-critical product into 3 x
    TF32, the in-place pipeline's short ones too, instead of running those
    IEEE: the measurement behind precision._SPLIT_MIN_K."""
    k = precision._SPLIT_MIN_K
    precision._SPLIT_MIN_K = 0
    try:
        yield
    finally:
        precision._SPLIT_MIN_K = k


def phase_precision(dev, crps_fit, times):
    """Phase 11: the precision modes (gpscore_torch.utils.precision)."""
    PREC_FAILED.clear()
    phase_gram2(dev, times)
    phase_precision_small(dev)
    gemm = phase_tf32_gemm(dev)
    vg = bench_ceiling.value_and_grad
    n, n2 = LARGE_N, 4.0 * LARGE_N * LARGE_N
    x, y, xt, _ = (t.to(dev) for t in large_n.make_data(n, LARGE_D, LARGE_TEST))
    p0 = init_unit_params(LARGE_D, isotropic=False, device=dev)

    # 4. At n = 30,720, step 0 of each rule in each mode: counted from here on.
    gram_cuda.reset_launches()
    steps = {}
    for rule in PREC_LARGE_RULES:
        loss = make_objective(rule, model="exact", fold_k=FOLD_K, num_sim=NUM_SIM)
        for mode in ["highest"] + PREC_MODES:
            with precision.matmul_mode(mode):
                (v, g), peak = peak_of(lambda: vg(loss, p0, x, y))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vg(loss, p0, x, y)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                busy, kinds, top, pwall = bench_ceiling.device_profile(lambda: vg(loss, p0, x, y))
                syncs = None
                if rule == "crps":
                    sched = large_n.schedule_for(rule, n, 1)
                    syncs = [w for w in host_syncs(lambda: fit_gd(loss, p0, x, y, 1, sched.lr))
                             if "set_sync_debug_mode" not in w]
            steps[(rule, mode)] = {"v": float(v), "g": {f: t.cpu() for f, t in g.items()},
                                   "peak": peak / n2, "wall": wall, "busy": busy,
                                   "kinds": kinds, "idle": 1.0 - busy / pwall, "syncs": syncs,
                                   "top": top[:6]}
            torch.cuda.empty_cache()
    variant = {}
    for rule in ("crps", "nlml"):
        loss = make_objective(rule, model="exact")
        with precision.matmul_mode("high"), every_product_tf32x3():
            vg(loss, p0, x, y)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v, g = vg(loss, p0, x, y)
            torch.cuda.synchronize()
            variant[rule] = (float(v), {f: t.cpu() for f, t in g.items()},
                             time.perf_counter() - t0)
        torch.cuda.empty_cache()
    inverse = f64_inverse(x, y, p0)
    for rule in PREC_LARGE_RULES:
        v64, g64 = f64_step0(rule, x, y, p0, inverse=inverse)
        g64 = {f: t.cpu() for f, t in g64.items()}
        top = steps[(rule, "highest")]
        limits = FOLD_F64_GRAD_RTOL if rule in FOLD_RULES else F64_GRAD_RTOL
        flop = bench_ceiling.step_flop(rule, n, FOLD_K)
        for mode in ["highest"] + PREC_MODES:
            st = steps[(rule, mode)]
            finite = np.isfinite(st["v"]) and all(torch.isfinite(t).all() for t in st["g"].values())
            e64 = (abs(st["v"] - v64) / abs(v64), {f: grad_rel({f: st["g"][f]}, {f: g64[f]})
                                                   for f in g64})
            etop = (abs(st["v"] - top["v"]) / abs(top["v"]), grad_rel(st["g"], top["g"]))
            kinds = ", ".join(f"{k} {t * 1e3:.1f}" for k, t in st["kinds"].items())
            log(f"[precision] n = {n}, {rule}, {mode}: loss {st['v']:.7g}{'' if finite else ' (NOT FINITE)'}"
                f"; against float64 loss rel {e64[0]:.3g}, grad rel by leaf "
                + ", ".join(f"{f} {e:.3g}" for f, e in e64[1].items())
                + f"; against highest loss rel {etop[0]:.3g}, grad rel {etop[1]:.3g}; wall per "
                f"step {st['wall']:.4f} s, {flop / st['wall'] / 1e12:.2f} effective TFLOP/s; "
                f"device busy {st['busy']:.4f} s (ms by kind: {kinds}), idle share "
                f"{st['idle']:.4f}; peak {st['peak']:.3f} n^2 * 4 B"
                + ("" if st["syncs"] is None else f"; host syncs in one GD step: "
                   f"{len(st['syncs'])} {st['syncs']}")
                + "; largest device kernels (ms): "
                + "; ".join(f"{k[:60]} {t * 1e3:.1f}" for k, t in st["top"]))
            if st["syncs"] is not None:
                check(not st["syncs"], rule, mode, st["syncs"])
            if mode in ("highest", "high"):
                check(e64[0] <= LARGE_LOSS_RTOL
                      and all(e <= limits[f] for f, e in e64[1].items()),
                      rule, mode, "against float64", e64)
            if mode in ("high", "fast", "f16"):
                check(finite, rule, mode, "not finite", st["v"])
            if mode in ("high", "fast"):
                check(st["peak"] <= PEAK_LIMIT_N2, rule, mode, "peak", st["peak"])
            if mode in STORAGE:
                check(st["peak"] <= top["peak"] - PEAK_SAVE_N2, rule, mode, "peak", st["peak"],
                      top["peak"])
        if rule in variant:
            vv, vg_, vwall = variant[rule]
            log(f"[precision] n = {n}, {rule}, high with every product at 3 x TF32 (not the "
                f"package's choice): wall per step {vwall:.4f} s; loss rel "
                f"{abs(vv - v64) / abs(v64):.3g}, grad rel by leaf "
                + ", ".join(f"{f} {grad_rel({f: vg_[f]}, {f: g64[f]}):.3g}" for f in g64)
                + f" against float64; against highest grad rel {grad_rel(vg_, top['g']):.3g}")

    # 5. The in-place factor per mode against float64; fit_gd_recovering from bf16.
    del inverse
    torch.cuda.empty_cache()
    with torch.no_grad():
        L64 = f64_factor(x, p0)[3]
        lp = (p0.log_signal_sq, p0.log_length, p0.log_noise_sq, x)
        block = auto_block(n, device=dev)
        errs = {}
        for mode in ["highest"] + PREC_MODES:
            with precision.matmul_mode(mode):
                L, hld = potri_inplace.ard_gram_chol_inplace(*lp, block,
                                                             storage=precision.storage_dtype())
                errs[mode] = (rel_max(L, L64), str(L.dtype).replace("torch.", ""))
                del L
        del L64
        torch.cuda.empty_cache()
    log(f"[precision] in-place Cholesky factor of K_hat at n = {n} against float64, relative to "
        "the largest entry: " + ", ".join(f"{m} ({dt}) {e:.3g}" for m, (e, dt) in errs.items()))
    for rule in ("crps", "dss"):
        loss = make_objective(rule, model="exact", fold_k=FOLD_K, num_sim=NUM_SIM)
        sched = large_n.schedule_for(rule, n, RECOVER_ITERS)
        t0 = time.perf_counter()
        with precision.matmul_mode("bf16"):
            res, info = train.fit_gd_recovering(loss, p0, x, y, RECOVER_ITERS, sched.lr, rule=rule)
        wall = time.perf_counter() - t0
        hist = res.loss_history.cpu().tolist()
        log(f"[precision] fit_gd_recovering from bf16, {rule}, {RECOVER_ITERS} iterations at "
            f"n = {n}: {wall:.2f} s; stall_iters {info['stall_iters']}, recovery "
            f"{info['recovery']}, legs {[(g['mode'], g['iters'], g['wall_s']) for g in info['segments']]}"
            f", losses {hist}")
        check("unrecovered_iters" not in info and int(res.stall_iters) == 0
              and all(np.isfinite(hist)), rule, "fit_gd_recovering", info, hist)

    # 7. The storage-aware predictive of the crps fit (phase 8's parameters).
    with torch.no_grad():
        f32 = exact_mod.exact_predictive_diag_large(x, y, xt, crps_fit, chunk=LARGE_TEST)
        preds = {r: exact_mod.exact_predictive_diag_large(x, y, xt, crps_fit, chunk=LARGE_TEST,
                                                          storage=torch.float16, refine=r)
                 for r in (0, 8)}
        torch.cuda.empty_cache()
        f64 = f64_predictive(x, y, xt, crps_fit)
        torch.cuda.empty_cache()
    gaps = {}
    for name, pr in [("fp32", f32), ("f16", preds[0]), ("f16 refine 8", preds[8])]:
        gaps[name] = (rel_max(pr.mean, f64[0]), rel_max(pr.cov, f64[1]),
                      rel_max(pr.mean, f32.mean), rel_max(pr.cov, f32.cov))
    log(f"[precision] the crps fit's large-n predictive at {LARGE_TEST} test points, relative to "
        "the largest entry (mean, variance) against float64 | against the fp32 predictive: "
        + "; ".join(f"{k} {a:.3g}, {b:.3g} | {c:.3g}, {d:.3g}" for k, (a, b, c, d) in gaps.items())
        + f" (limit {LARGE_EVAL_RTOL} for f16 refine 8 against float64)")
    check(max(gaps["f16 refine 8"][:2]) <= LARGE_EVAL_RTOL, "refined f16 predictive", gaps)

    # 8. The large_n experiment under --matmul at a cut size.
    drivers = {}
    for mode in ("bf16", "high"):
        argv = DRIVER_LARGE + ["--rules", "crps", "dss", "--matmul", mode]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            drivers[mode] = large_n.main(argv + ["--device", str(dev)])
        for rule, rec in drivers[mode].items():
            check(all(np.isfinite(rec[k]) for k in ("loss_first", "loss_last", *METRICS))
                  and "unrecovered_iters" not in rec, "large_n", mode, rec)
        log(f"[precision-large_n] {' '.join(argv)}: {time.perf_counter() - t0:.2f} s; "
            + "; ".join(f"{r} s_per_iter_steady {rec['s_per_iter_steady']:.4f}, recovery "
                        f"{rec['recovery']}, eval {rec['eval_storage']}, test crps {rec['crps']:.5f}"
                        for r, rec in drivers[mode].items()))
    torch.cuda.synchronize()
    launches = dict(gram_cuda.LAUNCHES)
    log(f"[precision] modes x rules at n = {n}, the recovering fits, the predictives and the "
        f"drivers: kernel launches {launches}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the precision path")
    del x, y, xt
    torch.cuda.empty_cache()

    # 6. Replayed FITC fits under "high" and "fast", equal to eager bit for bit.
    # FITC's products are short, so "high" runs them IEEE; "fast" takes one
    # TF32 pass at every size, so its graph holds TF32 kernels.
    data = load_kin40k()
    gpu = kin40k_replicate_split(data, 0, device=dev)
    sched = SCHEDULES[("kin40k_fitc", "crps")]
    loss = make_objective("crps", model="fitc")
    p_fitc = kin40k_fitc20_init(dev)
    top = fit_gd(loss, p_fitc, gpu.train_x, gpu.train_y, GRAPH_STEPS, sched.lr, sched.lr_inducing,
                 graph=False)
    for mode in ("high", "fast"):
        with precision.matmul_mode(mode):
            runs = [fit_gd(loss, p_fitc, gpu.train_x, gpu.train_y, GRAPH_STEPS, sched.lr,
                           sched.lr_inducing, record_params=True, graph=g) for g in (False, True)]
        differ = fits_equal(runs[1], runs[0])
        check(not differ, mode, "replayed vs eager", differ, first_parting(runs[1], runs[0]))
        if mode == "fast":
            check(first_parting(runs[0], top) is not None, mode, "no TF32 pass in the fit")
        h = runs[1].loss_history
        log(f"[precision] FITC-20 crps under {mode}, {GRAPH_STEPS} steps replayed against eager: "
            f"{'equal bit for bit' if not differ else 'DIFFERENT'} (histories, final parameters, "
            f"stall_iters); loss {float(h[0]):.6f} -> {float(h[-1]):.6f}, first step apart from "
            f"the highest fit: {first_parting(runs[0], top)}")
    assert not PREC_FAILED, PREC_FAILED
    return launches, gemm


def batched_kernel_inputs(B, n, m, d, dev, seed, square=False, dtype=torch.float32):
    """B sets of kernel_inputs stacked: xs [B, n, d], xps [B, m, d], g
    [B, n, m], and sig [B] = e (1 - 0.02 b), so the batch strides of every
    array, sig's included, are exercised."""
    sets = [kernel_inputs(n, m, d, dev, seed=seed * 1000 + b, square=square, dtype=dtype)
            for b in range(B)]
    xs, xps, _, g = (torch.stack([st[i] for st in sets]) for i in (0, 1, 2, 3))
    sig = np.e * (1.0 - 0.02 * torch.arange(B, dtype=dtype, device=dev))
    return xs.contiguous(), xps.contiguous(), sig, g.contiguous()


def tiled_alike(plan, B, n, m, d, sms):
    """Whether ``plan`` tiles one of B Grams as it tiles the Gram alone (then
    the backward's sums run in the same order)."""
    batched, alone = plan(n, m, d, sms, B), plan(n, m, d, sms)
    extra = {"blocks": alone.blocks} if hasattr(alone, "blocks") else {}
    return batched._replace(batch=1, **extra) == alone


def kernel_calls():
    """Kernel name -> (wrapper, plain version), each taking (xs, xps, sig, g)
    and returning a tuple of outputs."""
    return {"gram_fwd": (lambda a, b, c, _: (gram_cuda.gram_fwd_cuda(a, b, c),),
                         lambda a, b, c, _: (gram_cuda.gram_fwd_plain(a, b, c),)),
            "gram_bwd_rows": (gram_cuda.gram_bwd_rows_cuda, gram_cuda.gram_bwd_rows_plain),
            "gram_bwd_cols": (lambda *a: (gram_cuda.gram_bwd_cols_cuda(*a),),
                              lambda *a: (gram_cuda.gram_bwd_cols_plain(*a),))}


def time_kernel(name, kern, plain, shape, reps, warmup, loop=None, shared_x=False):
    """Times of a batched kernel call ``kern`` beside its ``plain`` version
    (plain, kernel, [loop, loop,] kernel, plain; CUDA events), its device time
    (torch.profiler) and the roofline bound of ``shape`` (B, n, m, d);
    ``shared_x`` when the call is given one tensor as xs and xps. Returns
    (times, bound)."""
    B, n, m, d = shape
    fns = (plain, kern, loop, loop, kern, plain) if loop else (plain, kern, kern, plain)
    ms = [cuda_ms(f, reps=reps, warmup=warmup) for f in fns]
    bound = gram_cuda.roofline(name, n, m, d, batch=B, shared_x=shared_x)
    dev_ms, ops = device_ms(kern, reps=reps, floor_ms=bound.bound_us / 1e3)
    t = {"ms": (ms[1] + ms[-2]) / 2, "plain_ms": (ms[0] + ms[-1]) / 2, "device_ms": dev_ms,
         "bound_ms": bound.bound_us / 1e3, "bound_by": bound.bound_by, "library_ms": None,
         "launches_per_call": ops, "timed_by": "torch.profiler"}
    if dev_ms is None:  # the profiler lost the events: the share of the CUDA-event time
        del t["device_ms"]
        t["timed_by"] = "cuda_events"
    t["roofline_share"] = bound.bound_us / 1e3 / t.get("device_ms", t["ms"])
    if loop:
        t["loop_ms"] = (ms[2] + ms[3]) / 2
    return t, bound


def sweep_kernels(dev, err, shapes=SWEEP_SHAPES, squares=SWEEP_SQUARE, tag="sweeps"):
    """Phase 12 (1), and phase 16 (1) at its ``shapes``: the batched kernels
    against their batched plain versions, bitwise the unbatched launch at B =
    1, a second call bitwise equal; timed beside a loop of B unbatched
    launches and the batched roofline bound. Returns {shape key: {kernel:
    times}}."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for s, (B, n, m, d) in enumerate(shapes):
        square = (n, m) in squares
        xs, xps, sig, g = batched_kernel_inputs(B, n, m, d, dev, seed=s, square=square)
        calls = {k: kp[0] for k, kp in kernel_calls().items()}
        plains = {k: kp[1] for k, kp in kernel_calls().items()}
        alike = {"gram_fwd": True,
                 "gram_bwd_rows": tiled_alike(gram_cuda.bwd_rows_plan, B, n, m, d, sms),
                 "gram_bwd_cols": tiled_alike(gram_cuda.bwd_cols_plan, B, n, m, d, sms)}
        key = f"{B}x{n}x{m}x{d}"
        errs, per_batch = {}, {}
        for name, call in calls.items():
            got = call(xs, xps, sig, g)
            assert all(torch.equal(a, b) for a, b in zip(got, call(xs, xps, sig, g))), \
                (key, name, "two calls on the same inputs differ")
            worst = 0.0
            for a, want in zip(got, plains[name](xs, xps, sig, g)):
                e = float((a - want).abs().max())
                tol = (FWD_ATOL if name == "gram_fwd"
                       else BWD_ATOL + BWD_RTOL * float(want.abs().max()))
                assert torch.isfinite(a).all() and e <= tol, (key, name, e, tol)
                worst = max(worst, e)
            errs[name] = worst
            err[name] = max(err[name], worst)
            # B = 1: a batch of one against today's unbatched launch, bit for bit.
            one = call(xs[:1], xps[:1], sig[:1], g[:1])
            solo = call(xs[0], xps[0], sig[0:1].reshape(()), g[0])
            assert all(torch.equal(a[0], b) for a, b in zip(one, solo)), (key, name, "B = 1")
            # Every batch against its unbatched launch: bitwise where tiled alike.
            gap = 0.0
            for b in range(B):
                alone = call(xs[b], xps[b], sig[b], g[b])
                for a, v in zip(got, alone):
                    if alike[name]:
                        assert torch.equal(a[b], v), (key, name, b)
                    gap = max(gap, float((a[b] - v).abs().max()))
            per_batch[name] = "bitwise" if alike[name] else f"tiled otherwise, max abs {gap:.3g}"
        torch.cuda.synchronize()
        log(f"[{tag}] {key}: errors against the batched plain versions "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tol fwd {FWD_ATOL}, bwd {BWD_ATOL} + {BWD_RTOL} * max|ref|); B = 1 bitwise "
            f"the unbatched launch; second call bitwise equal; each batch against its unbatched "
            f"launch: " + ", ".join(f"{k} {v}" for k, v in per_batch.items()))
        # Times: the batched launch, a loop of B unbatched launches, the plain
        # version; plain, kernel, loop, loop, kernel, plain.
        out[key] = {}
        for name, call in calls.items():
            def kern():
                return call(xs, xps, sig, g)

            def loop():
                return [call(xs[b], xps[b], sig[b], g[b]) for b in range(B)]

            def plain():
                return plains[name](xs, xps, sig, g)

            t, bound = time_kernel(name, kern, plain, (B, n, m, d), reps=50, warmup=5, loop=loop)
            out[key][name] = t
            log(f"[{tag}-time] {name} {key}: per call batched {t['ms']:.5f} ms, a loop of {B} "
                f"unbatched launches {t['loop_ms']:.5f} ms ({t['loop_ms'] / t['ms']:.2f}x), plain "
                f"{t['plain_ms']:.5f} ms; device {ms_text(t.get('device_ms'))}; bound "
                f"{bound.bound_us:.4f} us "
                f"by {bound.bound_by} ({bound.bytes} bytes, {bound.flops} FLOP), share "
                f"{t['roofline_share']:.3f}")
    return out


def batched_loss_and_grad(loss_fn, params, leaves, x, y):
    """The R losses [R] at ``leaves`` ([R, ...] each) and the gradient of
    each restart's own loss (of their sum)."""
    cur = {f: t.detach().clone().requires_grad_() for f, t in leaves.items()}
    loss = loss_fn(params.replace(**cur), x, y)
    return loss.detach(), dict(zip(cur, torch.autograd.grad(loss.sum(), list(cur.values()))))


def sweep_start(dev, R, model="fitc"):
    """R restarts as multi_restart draws them (uniform, CPU generator seeded
    0, all at once), moved to the card."""
    p = init_rand_params(torch.Generator().manual_seed(0), 8,
                         num_inducing=20 if model == "fitc" else 0, batch=R)
    return p.replace(**{f: t.to(dev) for f, t in p.leaves().items()})


def phase_sweeps(dev):
    """Phase 12: restarts and replicates as one batched fit. Returns the
    launches of the multi_restart and of the replicate sweep, the kernels'
    errors and the batched shapes' times."""
    err = {k: 0.0 for k in REPLACES}
    shapes = sweep_kernels(dev, err)
    gpu = kin40k_replicate_split(load_kin40k(), 0, device=dev)
    pb = sweep_start(dev, SWEEP_R)
    sweep_restarts(gpu.train_x, gpu.train_y, pb)
    launches = sweep_multi_restart(gpu.train_x, gpu.train_y, pb)
    replicate_launches = sweep_replicates(dev)
    sweep_syncs(gpu.train_x, gpu.train_y, pb)
    sweep_steps(dev, gpu.train_x, gpu.train_y)
    return launches, replicate_launches, err, shapes


def sweep_restarts(x, y, pb):
    """Phase 12 (2)."""
    R = batch_size(pb)
    # 2. restart_sweep of R FITC-20 restarts: replayed == eager, and at the
    # solo fits' recorded parameters the batched loss and gradient: against
    # the solo ones on the card, and both against a float64 witness on the
    # CPU, where the batched and the solo forms must also agree.
    x64, y64 = x.cpu().double(), y.cpu().double()
    for rule in ("crps", "nlml"):
        sched = SCHEDULES[("kin40k_fitc", rule)]
        loss = make_objective(rule, model="fitc")

        def fit(graph):
            return fit_gd_batch(loss, pb, x, y, SWEEP_STEPS, sched.lr, sched.lr_inducing,
                                record_params=True, graph=graph)

        eager, replayed = fit(False), fit(True)
        differ = fits_equal(replayed, eager)
        assert not differ, (rule, differ)
        solo = [fit_gd(loss, select_params(pb, r), x, y, SWEEP_STEPS, sched.lr,
                       sched.lr_inducing, record_params=True) for r in range(R)]
        leaves = list(pb.leaves())
        worst = {"loss": 0.0, "f64 identity": 0.0}
        vs_solo, b64, s64 = ({f: 0.0 for f in leaves} for _ in range(3))
        finite = 0
        for i in range(0, SWEEP_STEPS, SWEEP_CHECK_EVERY):
            at = {f: torch.stack([st.param_history.leaves()[f][i] for st in solo])
                  for f in leaves}
            lb, gb = batched_loss_and_grad(loss, pb, at, x, y)
            witness = i % SWEEP_F64_EVERY == 0
            if witness:
                at64 = {f: t.cpu().double() for f, t in at.items()}
                lb64, gb64 = batched_loss_and_grad(loss, pb, at64, x64, y64)
            for r, st in enumerate(solo):
                want = float(st.loss_history[i])
                assert np.isfinite(float(lb[r])) == np.isfinite(want), (rule, i, r)
                if not np.isfinite(want):
                    continue
                finite += 1
                worst["loss"] = max(worst["loss"], abs(float(lb[r]) - want) / abs(want))
                _, gs = loss_and_grad(loss, pb, {f: t[r] for f, t in at.items()}, x, y)
                for f in gs:
                    vs_solo[f] = max(vs_solo[f], float((gb[f][r] - gs[f]).abs().max())
                                     / float(gs[f].abs().max()))
                if not witness:
                    continue
                l64, g64 = loss_and_grad(loss, pb, {f: t[r] for f, t in at64.items()}, x64, y64)
                worst["f64 identity"] = max(worst["f64 identity"],
                                            abs(float(lb64[r] - l64)) / abs(float(l64)),
                                            *(float((gb64[f][r] - g64[f]).abs().max())
                                              / float(g64[f].abs().max()) for f in g64))
                for f in g64:
                    scale = float(g64[f].abs().max())
                    b64[f] = max(b64[f], float((gb[f][r].cpu().double() - g64[f]).abs().max())
                                 / scale)
                    s64[f] = max(s64[f], float((gs[f].cpu().double() - g64[f]).abs().max())
                                 / scale)
        solo_hist = torch.stack([st.loss_history for st in solo])
        rel = ((replayed.loss_history - solo_hist).abs() / solo_hist.abs()).nan_to_num(0.0)
        limit = {f: SWEEP_GRAD_RTOL.get(f, GRAD_RTOL) for f in leaves}
        log(f"[sweeps] restart_sweep fitc {rule}, R = {R}, {SWEEP_STEPS} steps: replayed == "
            f"eager bit for bit (loss and parameter histories [R, iters], final parameters, "
            f"stall_iters); final losses {float(replayed.loss_history[:, -1].min()):.6f} .. "
            f"{float(replayed.loss_history[:, -1].max()):.6f}, {int((~replayed.ok).sum())} "
            f"failed; at the solo fits' parameters (every {SWEEP_CHECK_EVERY}th step, {finite} "
            f"finite points) batched vs solo loss rel {worst['loss']:.3g} (tol {LOSS_RTOL}), "
            f"grad rel per leaf " + ", ".join(f"{f} {v:.3g}" for f, v in vs_solo.items())
            + f"; against float64 (every {SWEEP_F64_EVERY}th step) batched / solo "
            + ", ".join(f"{f} {b64[f]:.3g} / {s64[f]:.3g}" for f in leaves)
            + f" (tol {limit}); the batched and solo forms in float64 agree to "
            f"{worst['f64 identity']:.3g}; free-running batched vs solo max rel "
            f"{float(rel.max()):.3g}")
        assert worst["loss"] <= LOSS_RTOL and worst["f64 identity"] <= 1e-9, (rule, worst)
        for f in leaves:
            assert vs_solo[f] <= limit[f] and b64[f] <= limit[f], (rule, f, vs_solo, b64)


def sweep_multi_restart(x, y, pb):
    """Phase 12 (3): returns the sweeps path's launches."""
    R = batch_size(pb)
    # 3. multi_restart at its defaults: the sweeps path, counted.
    torch.cuda.synchronize()
    gram_cuda.reset_launches()
    t0 = time.perf_counter()
    res = multi_restart.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gram_cuda.LAUNCHES)
    iters = sum(SCHEDULES[("kin40k_fitc", r)].iters for r in ("crps", "nlml"))
    # Two Grams a step (K_uu, K_fu) for all R restarts, four in each evaluation.
    want = {"fwd": 2 * iters + 8, "bwd_rows": 2 * iters, "bwd_cols": 2 * iters}
    assert launches == want, (launches, want)
    for tag, rec in res.items():
        assert rec["num_restarts"] == R and np.isfinite(rec["best_final_loss"]), (tag, rec)
        assert all(np.isfinite(rec[f]) for f in METRICS), (tag, rec)
    sched = SCHEDULES[("kin40k_fitc", "crps")]
    loss = make_objective("crps", model="fitc")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo = [fit_gd(loss, select_params(pb, r), x, y, sched.iters, sched.lr, sched.lr_inducing)
            for r in range(R)]
    solo_final = torch.stack([s.loss_history[-1] for s in solo]).cpu()
    solo_wall = time.perf_counter() - t0
    log(f"[sweeps] multi_restart.main() at its defaults ({R} restarts, crps and nlml, FITC m = "
        f"20): {wall:.3f} s; kernel launches {launches} (one per Gram for all {R} restarts); "
        + "; ".join(f"{tag}: best restart {rec['best_restart']} final loss "
                    f"{rec['best_final_loss']:.6f}, worst {rec['worst_final_loss']:.6f}, "
                    f"{rec['num_failed']} failed, test crps {rec['crps']:.5f}"
                    for tag, rec in res.items())
        + f"; the same {R} crps restarts as {R} solo fit_gd fits: {solo_wall:.3f} s, best "
        f"final loss {float(solo_final.nan_to_num(float('inf')).min()):.6f}, "
        f"{int((~torch.isfinite(solo_final)).sum())} failed")
    return launches


def sweep_replicates(dev):
    """Phase 12 (4): returns the batched replicate sweep's launches."""
    # 4. kin40k_full --replicates 10: batched against the per-replicate loop.
    torch.cuda.synchronize()
    gram_cuda.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        batched = kin40k_full.main(["--replicates", str(SWEEP_REPLICATES), "--device", str(dev)])
    replicate_launches = dict(gram_cuda.LAUNCHES)
    data = load_kin40k()
    splits = [kin40k_replicate_split(data, j, device=dev) for j in range(SWEEP_REPLICATES)]
    looped = {}
    for rule in EXACT_RULES:
        sched = SCHEDULES[("kin40k_full", rule)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crps = []
        for j, sp in enumerate(splits):
            p0 = init_rand_params(common.replicate_generator(0, j), 8,
                                  unit_scalars=(rule != "crps"))
            m, _ = fit_and_eval(rule, "exact", sched,
                                p0.replace(**{f: t.to(dev) for f, t in p0.leaves().items()}),
                                sp.train_x, sp.train_y, sp.test_x, sp.test_y,
                                generator=common.replicate_generator(0, j, 1, device=dev))
            crps.append(m.crps)
        crps = float(torch.stack(crps).mean())
        torch.cuda.synchronize()
        looped[rule] = (time.perf_counter() - t0, crps)
    for rule, rec in batched.items():
        assert rec["num_failed"] == 0 and np.isfinite(rec["crps"]), (rule, rec)
        for k, v in replicate_launches.items():
            assert v > 0, (k, "not launched by the batched replicate sweep")
    total, loop_total = (sum(rec["wall_s"] for rec in batched.values()),
                         sum(v[0] for v in looped.values()))
    log(f"[sweeps] kin40k_full --replicates {SWEEP_REPLICATES} batched: summed wall_s "
        f"{total:.3f} s (" + ", ".join(f"{r} {rec['wall_s']:.3f}" for r, rec in batched.items())
        + f"); kernel launches {replicate_launches}; the per-replicate loop of fit_and_eval: "
        f"{loop_total:.3f} s (" + ", ".join(f"{r} {v[0]:.3f}" for r, v in looped.items())
        + f"), {loop_total / total:.2f}x; test crps batched / loop: "
        + ", ".join(f"{r} {rec['crps']:.5f} / {looped[r][1]:.5f}" for r, rec in batched.items()))
    return replicate_launches


def sweep_syncs(x, y, pb):
    """Phase 12 (5)."""
    R = batch_size(pb)
    loss = make_objective("crps", model="fitc")
    # 5. Host syncs of a batched replayed fit: none once the step is captured.
    sched = SCHEDULES[("kin40k_fitc", "crps")]
    marks = []
    with sync_warnings() as caught:
        def marking(params, xx, yy, generator=None):
            marks.append(len(sync_sites(caught)))
            return loss(params, xx, yy, generator)

        fit_gd_batch(marking, pb, x, y, GRAPH_SYNC_STEPS, sched.lr, sched.lr_inducing,
                     graph=True)
    sites = sync_sites(caught)
    assert len(marks) == train.GRAPH_WARMUP + 1, marks
    after = sites[marks[-1]:]
    log(f"[sweeps] host syncs of a batched replayed {GRAPH_SYNC_STEPS}-step fit (R = {R}): "
        f"{marks[-1]} before the captured step, {len(after)} from the captured step to the "
        f"return {after}")
    assert not after, after


def sweep_steps(dev, x, y):
    """Phase 12 (6)."""
    # 6. The replayed step at R = 1, 4, 16 and 64: time, device ops, idle share.
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm = train.GRAPH_WARMUP
    for model, rule in SWEEP_STEP_CASES:
        sched = SCHEDULES[("kin40k_fitc" if model == "fitc" else "kin40k_full", rule)]
        loss = make_objective(rule, model=model)
        for r in SWEEP_STEP_RS:
            start = sweep_start(dev, r, model)

            def fit(iters, graph=True):
                return fit_gd_batch(loss, start, x, y, iters, sched.lr, sched.lr_inducing,
                                    graph=graph)

            fit(warm, False)
            # The fastest of a few: one host hiccup in a long fit read 3.3x once.
            short_s = min(timed(lambda: fit(warm + 1)) for _ in range(3))
            long_s = min(timed(lambda: fit(warm + 1 + SWEEP_LONG)) for _ in range(2))
            step_us = (long_s - short_s) / SWEEP_LONG * 1e6
            ops, busy_us = bench.profile_replayed(fit, steps=SWEEP_PROFILED)
            setup_s = short_s - step_us / 1e6
            fit_s = setup_s + sched.iters * step_us / 1e6
            log(f"[sweeps-step] {model} {rule}, R = {r}: replayed step {step_us:.1f} us "
                f"({step_us / r:.1f} us a restart); {ops:.1f} device ops, busy {busy_us:.1f} us, "
                f"idle share {1 - busy_us / step_us:.3f}; warm-up and capture {setup_s * 1e3:.2f} "
                f"ms, {setup_s / fit_s:.4f} of a {sched.iters}-iteration fit, "
                f"{r / fit_s:.2f} restarts per second")


def check_and_time(key, names, args, shape, err, reps):
    """Phase 13's kernel shapes: each kernel in ``names`` against its plain
    version on ``args`` (xs, xps, sig, g) evaluated in float64 (at the
    surfaces' l = 0.2, |x / l|^2 reaches ~1,200, where the fp32 plain form's
    cancellation alone is 4e-5), then timed (plain, kernel, kernel, plain;
    CUDA events) with its device time (torch.profiler) and the batched
    roofline bound (x counted once where xs is xps). ``shape`` is (B, n, m,
    d). Returns {kernel: times}."""
    out = {}
    wide = [None if a is None else a.double() for a in args]
    for name in names:
        kern, plain = kernel_calls()[name]
        worst = 0.0
        for a, want in zip(kern(*args), plain(*wide)):
            e = float((a.double() - want).abs().max())
            tol = (FWD_ATOL if name == "gram_fwd"
                   else BWD_ATOL + BWD_RTOL * float(want.abs().max()))
            assert torch.isfinite(a).all() and e <= tol, (key, name, e, tol)
            worst = max(worst, e)
        del want
        err[name] = max(err[name], worst)
        t, bound = time_kernel(name, lambda k=kern: k(*args), lambda p=plain: p(*args), shape,
                               reps=reps, warmup=2, shared_x=args[0] is args[1])
        out[name] = t
        log(f"[analysis-kernels] {name} {key}: max abs err {worst:.3g} against the plain "
            f"version in float64; per call kernel {t['ms']:.5f} ms "
            f"({t['launches_per_call']} launch(es)), plain {t['plain_ms']:.5f} ms; device "
            f"{ms_text(t.get('device_ms'))}; bound {bound.bound_us:.4f} us by "
            f"{bound.bound_by} ({bound.bytes} bytes, {bound.flops} FLOP), share "
            f"{t['roofline_share']:.3f}")
    return out


def surface_gram_args(x, ls):
    """The inputs of a surface's one batched Gram: x scaled by each grid
    point's lengthscale (xs = xps [B, n, d]) and unit signal [B]."""
    log_len = torch.log(ls)[:, None].expand(ls.numel(), x.shape[-1])
    xs = gram_cuda.scale_inputs(x, log_len)
    return xs, xs, torch.ones(ls.numel(), device=x.device), None


def surface_grid(ls, ns):
    """The (lengthscale, noise sd) of every point of the Gl x Gs grid, row-major."""
    return ls.repeat_interleave(ns.numel()), ns.repeat(ls.numel())


def analysis_surfaces(dev, err):
    """Phase 13 (1)-(3)."""
    times = {}
    f32 = dict(dtype=torch.float32)
    ls = torch.linspace(0.2, 4.0, GRID, **f32)
    ns = torch.linspace(0.05, 1.5, GRID, **f32)
    cpu = analysis_figures.synthetic(42, "cpu", num_train=N_CONTOUR, num_test=8, num_va=8)
    gpu = type(cpu)(*(t.to(dev) for t in cpu))
    lsg, nsg = ls.to(dev), ns.to(dev)
    # (1) The four surfaces at the defaults, CUDA against the CPU.
    for rule in SURFACE_RULES:
        def surface():
            return analysis.objective_surface(gpu.train_x, gpu.train_y, lsg, nsg, rule=rule)

        gram_cuda.reset_launches()
        z = surface().cpu()
        launched = dict(gram_cuda.LAUNCHES)
        assert launched == {"fwd": 1, "bwd_rows": 0, "bwd_cols": 0}, (rule, launched)
        want = analysis.objective_surface(cpu.train_x, cpu.train_y, ls, ns, rule=rule)
        f64 = analysis.objective_surface(cpu.train_x.double(), cpu.train_y.double(),
                                         ls.double(), ns.double(), rule=rule)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(z), fin), (rule, "finite points differ")
        rel = {k: ((a.double() - b.double()).abs() / b.double().abs())[fin]
               for k, a, b in (("cpu", z, want), ("f64", z, f64), ("cpu_f64", want, f64))}
        assert float(rel["cpu"].max()) <= SURFACE_RTOL, (rule, float(rel["cpu"].max()))
        assert float(rel["f64"].max()) <= SURFACE_F64_SMALL_RTOL, (rule, float(rel["f64"].max()))
        ms = cuda_ms(surface, reps=10, warmup=2)
        busy, ops = device_ms(surface, reps=5, warmup=1)
        log(f"[analysis] surface {rule} {GRID}x{GRID} at n = {N_CONTOUR}: "
            f"{int(fin.sum())}/{fin.numel()} finite alike; max (median) rel: CUDA against the "
            f"CPU {float(rel['cpu'].max()):.3g} ({float(rel['cpu'].median()):.2g}; tol "
            f"{SURFACE_RTOL}), CUDA against float64 {float(rel['f64'].max()):.3g} "
            f"({float(rel['f64'].median()):.2g}; tol {SURFACE_F64_SMALL_RTOL}), the CPU against "
            f"float64 {float(rel['cpu_f64'].max()):.3g} ({float(rel['cpu_f64'].median()):.2g}); "
            f"kernel launches {launched}; {ms:.3f} ms a surface, device busy {ms_text(busy)} in "
            f"{ops} device ops")
    B = GRID * GRID
    times[f"{B}x{N_CONTOUR}x{N_CONTOUR}x1"] = check_and_time(
        f"{B}x{N_CONTOUR}x{N_CONTOUR}x1", ["gram_fwd"], surface_gram_args(gpu.train_x, surface_grid(
            lsg, nsg)[0]), (B, N_CONTOUR, N_CONTOUR, 1), err, reps=50)
    # (2) The crps surface at n = 500: time, peak, 16 points against float64.
    big = analysis_figures.synthetic(42, dev, num_train=N_SURFACE_LARGE, num_test=8, num_va=8)

    def surface500():
        return analysis.objective_surface(big.train_x, big.train_y, lsg, nsg, rule="crps")

    z, peak = peak_of(surface500)
    ms = cuda_ms(surface500, reps=3, warmup=1)
    oracle = parity_report.load_oracle()
    x64, y64 = big.train_x.double().cpu().numpy(), big.train_y.double().cpu().numpy()
    points = np.random.default_rng(0).choice(B, 16, replace=False)
    worst = 0.0
    for p in points:
        l, s = float(ls[p // GRID]), float(ns[p % GRID])
        K = oracle.rbf_gram(x64, x64, 0.0, 2.0 * np.log(l))
        want = oracle.crps_gaussian(*oracle.loo_identity(K, y64, s * s), y64)
        worst = max(worst, abs(float(z.reshape(-1)[p]) - want) / abs(want))
    assert torch.isfinite(z).all() and worst <= SURFACE_F64_RTOL, worst
    n2 = B * N_SURFACE_LARGE ** 2 * 4
    log(f"[analysis] surface crps {GRID}x{GRID} at n = {N_SURFACE_LARGE}: {ms:.2f} ms a surface; "
        f"peak {peak / 2**30:.2f} GiB ({peak / n2:.2f} x B n^2 * 4 B); 16 sampled points against "
        f"a float64 LOO (tests/oracle.py): max rel {worst:.3g} (tol {SURFACE_F64_RTOL})")
    key = f"{B}x{N_SURFACE_LARGE}x{N_SURFACE_LARGE}x1"
    times[key] = check_and_time(key, ["gram_fwd"], surface_gram_args(
        big.train_x, surface_grid(lsg, nsg)[0]), (B, N_SURFACE_LARGE, N_SURFACE_LARGE, 1), err,
        reps=10)
    times[key]["gram_fwd"]["surface_ms"] = ms
    times[key]["gram_fwd"]["surface_peak_bytes"] = peak
    # (3) Past the grid's z limit: 90,000 Grams in two launches.
    lsb = torch.linspace(0.2, 4.0, BIG_GRID, device=dev)
    nsb = torch.linspace(0.05, 1.5, BIG_GRID, device=dev)
    half = BIG_GRID // 2
    for rule in SURFACE_RULES:
        gram_cuda.reset_launches()
        z = analysis.objective_surface(gpu.train_x, gpu.train_y, lsb, nsb, rule=rule)
        torch.cuda.synchronize()
        launched = gram_cuda.LAUNCHES["fwd"]
        halves = torch.cat([analysis.objective_surface(gpu.train_x, gpu.train_y, part, nsb,
                                                       rule=rule)
                            for part in (lsb[:half], lsb[half:])])
        assert launched == 2 and bits_equal(z, halves), (rule, launched)
        assert torch.isfinite(z).all(), rule
    B = BIG_GRID * BIG_GRID
    grid_l = surface_grid(lsb, nsb)[0]
    args = surface_gram_args(gpu.train_x, grid_l)
    K = gram_cuda.gram_fwd_cuda(*args[:3])
    parts = [gram_cuda.gram_fwd_cuda(*(a[s:s + half * BIG_GRID] for a in args[:3]))
             for s in (0, half * BIG_GRID)]
    assert bits_equal(K, torch.cat(parts)), "the chunked Gram is not its halves' Grams"
    log(f"[analysis] {BIG_GRID}x{BIG_GRID} grid ({B} Grams, past {gram_cuda.MAX_BATCH}): two "
        f"gram_fwd launches a surface ({gram_cuda.batch_chunks(B)}); all four surfaces finite and "
        f"bitwise the same grid in two calls of {half * BIG_GRID}, and so is the Gram")
    key = f"{B}x{N_CONTOUR}x{N_CONTOUR}x1"
    times[key] = check_and_time(key, ["gram_fwd"], args, (B, N_CONTOUR, N_CONTOUR, 1), err,
                                reps=20)
    # ... and a batched ArdGram backward of 70,000 Grams against the CPU's plain one.
    Bb, n, m, d = BIG_BWD
    rng = np.random.default_rng(7)
    host = [torch.tensor(a.astype(np.float32)) for a in (
        rng.uniform(-3, 3, (Bb, n, d)), rng.uniform(-3, 3, (Bb, m, d)),
        rng.uniform(-1, 1, Bb), rng.uniform(-1, 1, (Bb, d)), rng.standard_normal((Bb, n, m)))]
    grads = {}
    for where in ("cuda", "cpu"):
        leaves = [t.to(dev if where == "cuda" else "cpu", copy=True).requires_grad_()
                  for t in host[:4]]
        gram_cuda.reset_launches()
        K = gram_cuda.ArdGram.apply(*leaves)
        got = torch.autograd.grad((K * host[4].to(K.device)).sum(), leaves)
        if where == "cuda":
            torch.cuda.synchronize()
            launched = dict(gram_cuda.LAUNCHES)
        grads[where] = [K.detach().cpu()] + [g.cpu() for g in got]
    assert launched == {"fwd": 2, "bwd_rows": 2, "bwd_cols": 2}, launched
    worst = []
    for i, (a, b) in enumerate(zip(grads["cuda"], grads["cpu"])):
        e = float((a - b).abs().max())
        tol = FWD_ATOL if i == 0 else BWD_ATOL + BWD_RTOL * float(b.abs().max())
        assert torch.isfinite(a).all() and e <= tol, ("ArdGram", Bb, i, e, tol)
        worst.append(e)
    log(f"[analysis] ArdGram at {Bb}x{n}x{m}x{d}: launches {launched}; K, d_x, d_xp, "
        f"d_log_signal, d_log_length against the CPU's plain version: max abs "
        + ", ".join(f"{e:.3g}" for e in worst))
    xs = (host[0] * torch.exp(-host[3])[:, None, :]).to(dev)
    xps = (host[1] * torch.exp(-host[3])[:, None, :]).to(dev)
    key = "x".join(map(str, BIG_BWD))
    times[key] = check_and_time(key, [k for k in REPLACES], (
        xs, xps, torch.exp(host[2]).to(dev), host[4].to(dev)), BIG_BWD, err, reps=20)
    return times


def curve_calls(grids):
    """Curve name -> a call (generator, eps) of it at the R grids and the
    driver's sizes, and the shapes of its normals."""
    pre_mu, pre_var, true_rhos, rr = grids
    S, N, T = 100, 500, len(true_rhos)
    es = [(N, 2), (N, S, 2), (N, S, 2)]
    fam = [(T, 200, 2), (T, 200, 64, 2), (T, 200, 64, 2)]
    return {
        "crps_mean": (lambda g, e: analysis.crps_mean_error_curve(g, pre_mu, eps=e), (10_000,)),
        "logs_mean": (lambda g, e: analysis.logs_mean_error_curve(g, pre_mu, eps=e), (10_000,)),
        "crps_var": (lambda g, e: analysis.crps_var_error_curve(g, pre_var, eps=e), (10_000,)),
        "logs_var": (lambda g, e: analysis.logs_var_error_curve(g, pre_var, eps=e), (10_000,)),
        "dss_mean": (lambda g, e: analysis.dss_mean_error_curve(g, pre_mu, eps=e), (N, 2)),
        "dss_var": (lambda g, e: analysis.dss_var_error_curve(g, pre_var, eps=e), (N, 2)),
        "es_mean": (lambda g, e: analysis.es_mean_error_curve(g, pre_mu, eps=e), es),
        "es_var": (lambda g, e: analysis.es_var_error_curve(g, pre_var, eps=e), es),
        "dss_correlation_curve": (lambda g, e: analysis.dss_correlation_curve(
            g, 0.5, rr, eps=e), (N, 2)),
        "es_correlation_curve": (lambda g, e: analysis.es_correlation_curve(
            g, 0.4, rr, num_data=200, eps=e), [(200, 2), (200, S, 2), (200, S, 2)]),
        "dss_correlation_family": (lambda g, e: analysis.dss_correlation_family(
            g, true_rhos, rr, eps=e), (T, N, 2)),
        "es_correlation_family": (lambda g, e: analysis.es_correlation_family(
            g, true_rhos, rr, num_sim=64, eps=e), fam),
    }


def analysis_curves(dev):
    """Phase 13 (4)."""
    host = torch.Generator().manual_seed(13)
    cpu_calls = curve_calls(analysis_figures.sensitivity_grids("cpu"))
    gpu_calls = curve_calls(analysis_figures.sensitivity_grids(dev))
    worst = {}
    t0 = time.perf_counter()
    for name, (call, shapes) in cpu_calls.items():
        eps = ([torch.randn(s, generator=host) for s in shapes] if isinstance(shapes, list)
               else torch.randn(shapes, generator=host))
        want = call(None, eps)
        moved = [e.to(dev) for e in eps] if isinstance(eps, list) else eps.to(dev)
        got = gpu_calls[name][0](None, moved).cpu()
        worst[name] = float((got - want).abs().max() / want.abs().max())
        assert torch.isfinite(got).all() and worst[name] <= CURVE_RTOL, (name, worst[name])
    log(f"[analysis] the twelve curves at the R grids, CUDA against the CPU at the same normals "
        f"({time.perf_counter() - t0:.1f} s): max abs over the curve's max, "
        + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()) + f" (tol {CURVE_RTOL})")
    grids = analysis_figures.sensitivity_grids(dev)
    pre_mu, pre_var, true_rhos, rr = (g.cpu() if torch.is_tensor(g) else g for g in grids)
    generator = torch.Generator(dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = {k: v.cpu() for k, v in analysis_figures.sensitivity_curves(generator, *grids).items()}
    wall = time.perf_counter() - t0
    zero = int(torch.argmin(pre_mu.abs()))
    for name in ("crps_mean", "logs_mean", "dss_mean", "es_mean"):
        assert int(c[name].argmin()) == zero, (name, c[name])
    assert float(c["dss_mean"][zero]) == 0.0 and float(c["es_mean"][zero]) == 0.0
    for name, lo, hi in (("crps_var", 0.5, 2.0), ("logs_var", 0.5, 2.0), ("dss_var", 0.5, 2.0),
                         ("es_var", 0.4, 2.5)):
        assert lo < float(pre_var[int(c[name].argmin())]) < hi, (name, c[name])
    at_truth = []
    for fam in ("dss_corr_family", "es_corr_family"):
        for i, r in enumerate(true_rhos):
            v = float(c[fam][i, int(torch.argmin((rr - r).abs()))])
            assert abs(v) <= 1e-6, (fam, r, v)
            at_truth.append(abs(v))
    log(f"[analysis] the twelve curves from a CUDA generator in {wall:.2f} s: mean curves least "
        f"at mu = 0 (dss, es 0 there), variance curves least at pre_sigma_sq "
        + ", ".join(f"{k} {float(pre_var[int(c[k].argmin())]):.2f}"
                    for k in ("crps_var", "logs_var", "dss_var", "es_var"))
        + f", the families' largest |value| at their true rho {max(at_truth):.2g}")


def phase_analysis(dev):
    """Phase 13: the analysis suite. Returns the analysis_figures run's
    kernel launches, the kernels' errors at its shapes and their times."""
    err = {k: 0.0 for k in REPLACES}
    times = analysis_surfaces(dev, err)
    analysis_curves(dev)
    # (5) The figure driver end to end, the counters zeroed just before.
    gram_cuda.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = analysis_figures.main(["--no-png", "--outdir", ANALYSIS_OUT])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gram_cuda.LAUNCHES)
    assert all(v > 0 for v in launches.values()), launches
    assert all(torch.isfinite(z).all() for z in out["surfaces"].values())
    assert all(torch.isfinite(c).all() for c in out["curves"].values())
    assert bool(out["fit"].ok) and torch.isfinite(out["prediction"].mean).all()
    sizes = {f: os.path.getsize(os.path.join(ANALYSIS_OUT, f)) for f in out["files"]}
    log(f"[analysis] analysis_figures --no-png: {wall:.2f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in out["timings"].items())
        + f" s); wrote {sizes}; kernel launches {launches}; FITC fit final loss "
        f"{float(out['fit'].loss_history[-1]):.6f}")
    # (6) The parity report on the card.
    with contextlib.redirect_stdout(io.StringIO()) as buf, \
            contextlib.redirect_stderr(io.StringIO()):
        rc = parity_report.main([])
    report = json.loads(buf.getvalue())
    assert rc == 0 and all(r["pass"] for r in report.values()), report
    errs = {k: next(v for f, v in r.items() if f.startswith("max_")) for k, r in report.items()}
    log("[analysis] parity_report float32 on the card, every target passes: "
        + ", ".join(f"{k} {errs[k]:.2g}/{report[k]['target']:.0e}" for k in sorted(report))
        + " (float64: phase 3)")
    # (7) The fit's FitResult through a pytree checkpoint onto the card.
    path = os.path.join(ANALYSIS_OUT, "fit_roundtrip.npz")
    checkpoint.save_pytree(path, out["fit"])
    back = checkpoint.load_pytree(path, out["fit"])
    mine, theirs = checkpoint.tree_leaves(back), checkpoint.tree_leaves(out["fit"])
    assert type(back) is type(out["fit"]) and len(mine) == len(theirs)
    assert all(a.device == b.device and bits_equal(a, b) for a, b in zip(mine, theirs))
    log(f"[analysis] the FitResult ({len(mine)} leaves, param_history "
        f"{tuple(back.param_history.inducing.shape)} inducing) round-trips save_pytree / "
        f"load_pytree onto {mine[0].device} bitwise")
    return launches, err, times


def mesh_steps(dev, mesh):
    """Phase 14 (3): the sharded LOO crps and k-fold dss steps at n = 30,720
    (phase 8's data and parameters) on the one-rank mesh: a first step with
    its peak memory, a second timed, each held against the float64 witness
    at phase 8's limits (crps) and phase 9's (dss)."""
    n, n2 = LARGE_N, 4.0 * LARGE_N * LARGE_N
    x, y, _, _ = (t.to(dev) for t in large_n.make_data(n, LARGE_D, LARGE_TEST))
    p0 = init_unit_params(LARGE_D, isotropic=False, device=dev)
    out = {}
    for rule, limits in (("crps", F64_GRAD_RTOL), ("dss", FOLD_F64_GRAD_RTOL)):
        def step():
            v, g = sharded_loo_value_and_grad(p0, shard_rows(x, mesh), y, mesh, rule=rule,
                                              block=MESH_BLOCK)
            return v, g.leaves()
        torch.cuda.empty_cache()
        (v, g), peak = peak_of(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rule not in F64_WITNESS:
            torch.cuda.empty_cache()
            F64_WITNESS[rule] = f64_step0(rule, x, y, p0)
        v64, g64 = F64_WITNESS[rule]
        lr_ = abs(float(v) - v64) / abs(v64)
        ge = {f: grad_rel({f: g[f]}, {f: g64[f]}) for f in g64}
        log(f"[mesh] sharded {rule} step at n = {n}, block {MESH_BLOCK}, one rank: {wall:.3f} s, "
            f"peak {peak / n2:.3f} n^2 * 4 B (limit {MESH_PEAK_LIMIT_N2}); against float64 loss "
            f"rel {lr_:.3g} (tol {LARGE_LOSS_RTOL}), grad rel by leaf "
            + ", ".join(f"{f} {e:.3g}" for f, e in ge.items()) + f" (tol {limits})")
        assert lr_ <= LARGE_LOSS_RTOL and all(e <= limits[f] for f, e in ge.items()), \
            (rule, lr_, ge)
        assert peak <= MESH_PEAK_LIMIT_N2 * n2, (rule, peak / n2)
        out[rule] = {"step_s": wall, "peak_n2": peak / n2, "loss_rel_f64": lr_,
                     "grad_rel_f64": ge}
    del x, y
    torch.cuda.empty_cache()
    return out


def mesh_cholesky(dev, mesh):
    """Phase 14 (4): sharded_cholesky, sharded_tri_solve_lower and
    sharded_nlml at n = 8192 on the one-rank mesh against float64."""
    n = MESH_SMALL_N
    x, y, _, _ = (t.to(dev) for t in large_n.make_data(n, LARGE_D, LARGE_TEST))
    p0 = init_unit_params(LARGE_D, isotropic=False, device=dev)
    with torch.no_grad():
        K = sharded_gram(shard_rows(x, mesh), p0.log_signal_sq, p0.log_length, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L = sharded_cholesky(add_noise_sharded(K.clone(), p0.noise_sq, mesh), mesh,
                             block=MESH_BLOCK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        w = sharded_tri_solve_lower(L, y, mesh, block=MESH_BLOCK)
        nl = float(sharded_nlml(K, y, p0.noise_sq, mesh, block=MESH_BLOCK))
        L64 = f64_factor(x, p0)[3]
        w64 = torch.linalg.solve_triangular(L64, y.double()[:, None], upper=False)[:, 0]
        nl64 = float(0.5 * n * np.log(2.0 * np.pi) + torch.log(L64.diagonal()).sum()
                     + 0.5 * w64 @ w64)
        e_l, e_w, e_n = rel_max(L, L64), rel_max(w, w64), abs(nl - nl64) / abs(nl64)
    log(f"[mesh] n = {n}, block {MESH_BLOCK}: sharded_cholesky {wall:.3f} s, against float64 "
        f"{e_l:.3g} (tol {MESH_FACTOR_RTOL}); sharded_tri_solve_lower {e_w:.3g} (tol "
        f"{MESH_SOLVE_RTOL}); sharded_nlml {nl:.8g} vs {nl64:.10g}, rel {e_n:.3g} (tol "
        f"{MESH_NLML_RTOL})")
    assert e_l <= MESH_FACTOR_RTOL and e_w <= MESH_SOLVE_RTOL and e_n <= MESH_NLML_RTOL, \
        (e_l, e_w, e_n)
    del K, L, L64
    torch.cuda.empty_cache()
    return {"cholesky_s": wall, "factor_rel_f64": e_l, "solve_rel_f64": e_w, "nlml_rel_f64": e_n}


@contextlib.contextmanager
def one_nccl_rank(dev):
    """A process group of one NCCL rank on ``dev`` (a ``file://`` store
    under build/), destroyed on the way out; yields the rank's device."""
    os.makedirs("build", exist_ok=True)
    store = os.path.abspath(os.path.join("build", f"smoke_store_{os.getpid()}"))
    if os.path.exists(store):
        os.unlink(store)
    mdev = init_distributed(dev, init_method=f"file://{store}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        yield mdev
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.unlink(store)


def phase_mesh(dev):
    """Phase 14: the mesh and the distributed dense stack on one rank under
    NCCL. Returns the sharded path's Gram launches and its records."""
    with one_nccl_rank(dev) as mdev:
        mesh = make_mesh(devices=mdev)
        log(f"[mesh] one NCCL rank on {mdev}: mesh {mesh.shape}")
        x, _, _, _ = (t.to(dev) for t in large_n.make_data(LARGE_N, LARGE_D, LARGE_TEST))
        p0 = init_unit_params(LARGE_D, isotropic=False, device=dev)
        s = kin40k_replicate_split(load_kin40k(None), 0, device=dev)
        pb = sweep_start(dev, SWEEP_R)
        sched = SCHEDULES[("kin40k_fitc", "crps")]
        floss = make_objective("crps", model="fitc")
        # The sharded path, counted: the Gram, the sweep, the two steps, the
        # Cholesky family and the dry run.
        torch.cuda.synchronize()
        gram_cuda.reset_launches()
        K_sh = sharded_gram(shard_rows(x, mesh), p0.log_signal_sq, p0.log_length, mesh)
        # Against the unsharded launch, which the sharded path's count leaves out.
        counted = dict(gram_cuda.LAUNCHES)
        xs = gram_cuda.scale_inputs(x, p0.log_length)
        same = torch.equal(K_sh, gram_cuda.gram_fwd_cuda(xs, xs, torch.exp(p0.log_signal_sq)))
        log(f"[mesh] sharded_gram at {LARGE_N}x{LARGE_N}x{LARGE_D}: bitwise gram_fwd: {same}")
        assert same
        del K_sh, xs
        torch.cuda.empty_cache()
        gram_cuda.LAUNCHES.update(counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swept = sharded_restart_sweep(floss, pb, s.train_x, s.train_y, sched.iters, sched.lr,
                                      mesh, lr_inducing=sched.lr_inducing)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        records = {"sweep_s": sweep_s, **mesh_steps(dev, mesh), **mesh_cholesky(dev, mesh)}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            dry = dryrun_multichip(mdev)
        torch.cuda.synchronize()
        dry_s = time.perf_counter() - t0
        launches = dict(gram_cuda.LAUNCHES)
        log(f"[mesh] the sharded path (Gram, sweep, the two steps, the Cholesky family, the dry "
            f"run): kernel launches {launches}")
        for k, v in launches.items():
            assert v > 0, f"kernel {k} was not launched on the sharded path"
        log(f"[mesh] dryrun_multichip legs (1)-(12) on one rank in {dry_s:.2f} s: {dry}")
        # Against the unsharded sweep (not counted).
        ref = restart_sweep(floss, pb, s.train_x, s.train_y, sched.iters, sched.lr,
                            lr_inducing=sched.lr_inducing)
        differ = [f for f in ("loss_history", "ok", "stall_iters")
                  if not bits_equal(getattr(swept, f), getattr(ref, f))]
        differ += [f for f, t in swept.params.leaves().items()
                   if not bits_equal(t, getattr(ref.params, f))]
        log(f"[mesh] sharded_restart_sweep, {SWEEP_R} FITC-20 crps restarts x {sched.iters} "
            f"iterations in {sweep_s:.3f} s: bitwise restart_sweep (loss history, ok, "
            f"stall_iters, every parameter): {not differ}")
        assert not differ, differ
    return launches, records


def f64_gaps(v, g, witness):
    """(loss rel, {leaf: grad rel}) of (v, g) against a float64 witness."""
    v64, g64 = witness
    return abs(float(v) - v64) / abs(v64), {f: grad_rel({f: g[f]}, {f: g64[f]}) for f in g64}


def phase_sharded_fused(dev):
    """Phase 15: the fused sharded steps (the in-place sharded K_hat^-1 and
    the streamed backward, gpscore_torch.parallel) on one NCCL rank at
    n = 30,720, block 256: per rule the step-0 loss and gradient against
    the single-device fused or fold-streamed step and phases 8 and 9's
    float64 witnesses, the wall time, the peak, the collectives issued
    against bench_sharded's analytic bytes; the f16 crps and dss steps; crps
    at block 2048. Returns the path's Gram launches and its records."""
    n, n2 = LARGE_N, 4.0 * LARGE_N * LARGE_N
    x, y, _, _ = (t.to(dev) for t in large_n.make_data(n, LARGE_D, LARGE_TEST))
    p0 = init_unit_params(LARGE_D, isotropic=False, device=dev)
    eps = torch.cat(fold_eps(n, dev), dim=-1)  # phase 9's normals, [k, nb, 2 NUM_SIM]
    # The single-device steps and the float64 logs witness, not counted.
    single = {}
    for rule in FUSED_RULES:
        loss = make_objective(rule, model="exact", fold_k=FOLD_K, num_sim=NUM_SIM)
        kw = {"eps": tuple(eps.split(NUM_SIM, dim=-1))} if rule == "es" else {}
        v, g = bench_ceiling.value_and_grad(loss, p0, x, y, **kw)
        single[rule] = (float(v), {f: t.cpu() for f, t in g.items()})
        torch.cuda.empty_cache()
    if "logs" not in F64_WITNESS:
        F64_WITNESS["logs"] = f64_step0("logs", x, y, p0)
        torch.cuda.empty_cache()
    for rule in FUSED_RULES:
        if rule not in F64_WITNESS:  # phase 15 alone: its own witnesses
            F64_WITNESS[rule] = f64_step0(rule, x, y, p0, eps=tuple(eps.split(NUM_SIM, dim=-1)))
            torch.cuda.empty_cache()

    records, failed = {}, []
    with one_nccl_rank(dev) as mdev:
        mesh = make_mesh(devices=mdev, batch=1, data=1)
        x_loc = shard_rows(x, mesh)
        torch.cuda.synchronize()
        gram_cuda.reset_launches()
        runs = [(r, "highest", MESH_BLOCK) for r in FUSED_RULES]
        runs += [(r, "f16", MESH_BLOCK) for r in FUSED_F16_RULES]
        runs += [("crps", "highest", FUSED_WIDE_BLOCK)]
        for rule, mode, block in runs:
            # lr 1: from the unit parameters p0 = 1 the gradient is 1 - p1,
            # exact to half an fp32 ulp of 1.
            step = bench_sharded.make_step(mesh, rule, block, lr=1.0, fold_k=FOLD_K,
                                           num_sim=NUM_SIM)
            kw = {"eps": eps} if rule == "es" else {}
            torch.cuda.empty_cache()
            reset_collectives()
            with precision.matmul_mode(mode):
                (v, p1), peak = peak_of(lambda: step(p0, x_loc, y, **kw))
                issued = {k: dict(c) for k, c in COLLECTIVES.items() if c["count"]}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(p0, x_loc, y, **kw)  # the timed call: the path's first call warms it
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            g = {f: (t.double() - getattr(p1, f).double()).cpu() for f, t in p0.leaves().items()}
            limits = FOLD_F64_GRAD_RTOL if rule in FOLD_RULES else F64_GRAD_RTOL
            lr64, ge64 = f64_gaps(v, g, F64_WITNESS[rule])
            lrs, ges = f64_gaps(v, g, single[rule])
            sent = sum(c["bytes"] for c in issued.values())
            want = bench_sharded.analytic_collective_bytes(n, LARGE_D, block, 1, rule,
                                                           2 if mode == "f16" else 4)
            key = f"{rule}/{mode}/{block}"
            records[key] = {"step_s": wall, "peak_n2": peak / n2, "loss": float(v),
                            "loss_rel_f64": lr64, "grad_rel_f64": ge64, "loss_rel_single": lrs,
                            "grad_rel_single": ges, "collectives": issued}
            finite = np.isfinite(float(v)) and all(torch.isfinite(t).all() for t in g.values())
            log(f"[fused] sharded {rule}, {mode}, block {block}, n = {n}, one rank: {wall:.3f} s, "
                f"peak {peak / n2:.3f} n^2 * 4 B; loss {float(v):.7g}; against float64 loss rel "
                f"{lr64:.3g}, grad rel by leaf "
                + ", ".join(f"{f} {e:.3g}" for f, e in ge64.items())
                + f"; against the single-device step loss rel {lrs:.3g}, grad rel by leaf "
                + ", ".join(f"{f} {e:.3g}" for f, e in ges.items())
                + f" (tol {LARGE_LOSS_RTOL}, {limits}{' in highest' if mode == 'f16' else ''}); "
                f"collectives {issued}, {sent} bytes (analytic "
                f"{want['analytic_collective_bytes']})")
            if sent != want["analytic_collective_bytes"]:
                failed.append((key, "collectives", sent, want))
            if rule in ("crps", "dss") and mode == "highest" and block == MESH_BLOCK:
                busy, kinds, _, pwall = bench_ceiling.device_profile(
                    lambda: step(p0, x_loc, y, **kw))
                records[key].update(busy_s=busy, busy_by_kind=kinds, idle_share=1 - busy / pwall)
                log(f"[fused] sharded {rule}, a profiled step: device busy {busy:.4f} s of "
                    f"{pwall:.4f} s (ms by kind: "
                    + ", ".join(f"{k} {t * 1e3:.1f}" for k, t in kinds.items())
                    + f"), idle share {1 - busy / pwall:.4f}")
            if mode == "f16":  # phase 11's 2-byte limits: finite, 0.45 under highest's peak
                top = records[f"{rule}/highest/{MESH_BLOCK}"]["peak_n2"]
                if not finite or peak / n2 > top - PEAK_SAVE_N2:
                    failed.append((key, "f16", float(v), peak / n2, top))
                continue
            if not (lr64 <= LARGE_LOSS_RTOL and lrs <= LARGE_LOSS_RTOL
                    and all(e <= limits[f] for f, e in ge64.items())
                    and all(e <= limits[f] for f, e in ges.items())):
                failed.append((key, "accuracy", lr64, ge64, lrs, ges))
            if peak > PEAK_LIMIT_N2 * n2:
                failed.append((key, "peak", peak / n2))
        torch.cuda.synchronize()
        launches = dict(gram_cuda.LAUNCHES)
    log(f"[fused] the fused sharded path ({len(runs)} steps): kernel launches {launches}")
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched on the fused sharded path"
    assert not failed, failed
    del x, y, eps
    torch.cuda.empty_cache()
    return launches, records


def phase_results_parity(dev):
    """Phase 16: the RESULTS.md sweep tables' quick subset through
    results_parity, from the JAX package's initial draws, paired per replicate
    against its committed CPU fits. Returns the path's launches and the
    kernels' errors and times at its batched shapes."""
    err = {k: 0.0 for k in REPLACES}
    times = sweep_kernels(dev, err, PARITY_SHAPES, PARITY_SQUARE, tag="parity")
    # (2) results_parity --quick, the launch counters zeroed just before and
    # read just after (the "results_parity" path).
    torch.cuda.synchronize()
    gram_cuda.reset_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = results_parity.main(["--quick", "--outdir", PARITY_OUT])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gram_cuda.LAUNCHES)
    lines = out.getvalue().splitlines()
    checks = [ln for ln in lines if ln.startswith(("[verdict]", "[jax-eval]"))]
    for ln in lines:
        if ln.startswith(("[verdict]", "[jax-eval]", "[vs nlml]", "[table]")):
            log("[parity] " + ln)
    assert rc == 0 and checks and all(ln.endswith(": pass") for ln in checks), \
        [ln for ln in checks if not ln.endswith(": pass")]
    assert all(v > 0 for v in launches.values()), launches
    with open(os.path.join(PARITY_OUT, "verdicts.json")) as f:
        summary = json.load(f)
    assert summary["num_failed"] == 0 and summary["num_checks"] == len(checks), summary
    log(f"[parity] results_parity --quick: {wall:.2f} s ("
        + ", ".join(f"{t} {w:.2f}" for t, w in summary["wall_s"].items())
        + f" s), {len(checks)} checks pass; kernel launches {launches}")
    return launches, err, times


# Phase 17.
WIDE_D = 90  # the song set's width (YearPredictionMSD, a UCI GP benchmark)
WIDE_FITC = (500, 20)  # n, m of the FITC-20 fit at that width
WIDE_RULES = ["crps", "nlml"]
WIDE_LARGE_RULES = ["crps", "dss"]  # the fused LOO core and the fold-streamed one
WIDE_TIMED = (50, 250)  # two replayed fits whose difference times a replayed step
# The float64 limits of the large-n steps: phase 8's for crps, phase 9's for
# the fold rule.
WIDE_F64_GRAD_RTOL = {"crps": F64_GRAD_RTOL, "dss": FOLD_F64_GRAD_RTOL}


def wide_fitc_problem(d):
    """The FITC-20 problem at width d, on the CPU: large_n's data (seed 0),
    its first m rows as inducing points, unit parameters with the log
    lengths raised by log(d / 8) / 2 (bench_wide.wide_params)."""
    n, m = WIDE_FITC
    x, y, _, _ = large_n.make_data(n, d, 0)
    return x, y, bench_wide.wide_params(d, "cpu").replace(inducing=x[:m].clone())


def off_diagonal_span(K, sig):
    """(smallest, largest) entry of K off its diagonal, asserted to span a
    range (the smallest under half the largest) above 1% of sig: W is not
    zero off the diagonal, so the comparisons that follow are not vacuous."""
    off = K[~torch.eye(K.shape[0], dtype=torch.bool, device=K.device)]
    lo, hi = float(off.min()), float(off.max())
    assert lo < 0.5 * hi and hi > 0.01 * float(sig), (lo, hi, float(sig))
    return lo, hi


def phase_wide(dev):
    """Phase 17: the main path at the song set's width, d = 90, where the
    Gram backward runs its d-chunked kernels. (a) The FITC-20 fit at n =
    500, m = 20, crps and nlml, through fit_gd's replayed step, CUDA against
    the CPU at the same parameters (phase 4's limits); the microseconds of a
    replayed step at d = 90 and at d = 8, and the Gram kernels' device time
    in it. (b) The exact GP's large-n step at n = 30,720, crps (fused LOO)
    and dss (fold-streamed), step 0 against float64 within phases 8 and 9's
    limits; the step's seconds, peak and the Gram backward's milliseconds.
    The lengths are scaled so that K is no identity, and that is asserted."""
    t_phase = time.perf_counter()
    x, y, p_cpu = wide_fitc_problem(WIDE_D)
    lo, hi = off_diagonal_span(gram(x, x, p_cpu.log_signal_sq, p_cpu.log_length),
                               torch.exp(p_cpu.log_signal_sq))
    xg, yg, p_gpu = x.to(dev), y.to(dev), params_from_numpy(params_to_numpy(p_cpu), device=dev)
    n, m = WIDE_FITC
    log(f"[wide] FITC-20 at n = {n}, m = {m}, d = {WIDE_D}: K(x, x) off the diagonal spans "
        f"{lo:.3g} to {hi:.3g}")
    gram_cuda.reset_launches()
    fits = {}
    for rule in WIDE_RULES:
        sched = SCHEDULES[("kin40k_fitc", rule)]
        fits[rule] = fit_gd(make_objective(rule, model="fitc"), p_gpu, xg, yg, SMOKE_STEPS,
                            sched.lr, sched.lr_inducing, record_params=True)
    torch.cuda.synchronize()
    launches = dict(gram_cuda.LAUNCHES)
    assert all(v > 0 for v in launches.values()), launches
    for rule in WIDE_RULES:
        loss_fn = make_objective(rule, model="fitc")
        res = fits[rule]
        hist = res.loss_history.cpu()
        assert torch.isfinite(hist).all() and int(res.stall_iters) == 0, rule
        worst = {"loss": 0.0, "grad": 0.0}
        for i in range(SMOKE_STEPS):
            at = leaves_of(res.param_history, i)
            lg, gg = loss_and_grad(loss_fn, p_gpu, at, xg, yg)
            lc, gc = loss_and_grad(loss_fn, p_cpu, {f: v.cpu() for f, v in at.items()}, x, y)
            worst["loss"] = max(worst["loss"], abs(float(lg) - float(lc)) / abs(float(lc)))
            worst["grad"] = max(worst["grad"], grad_rel(gg, gc))
        log(f"[wide] FITC-20 {rule}, {SMOKE_STEPS} steps replayed: loss {float(hist[0]):.6f} "
            f"-> {float(hist[-1]):.6f}; at the CUDA points, CPU vs CUDA loss rel "
            f"{worst['loss']:.3g} (tol {LOSS_RTOL}), grad rel {worst['grad']:.3g} (tol "
            f"{GRAD_RTOL})")
        assert worst["loss"] <= LOSS_RTOL and worst["grad"] <= GRAD_RTOL, (rule, worst)
    log(f"[wide] FITC-20 fits: kernel launches {launches}")
    for d in (WIDE_D, 8):
        xd, yd, pd = wide_fitc_problem(d)
        xd, yd = xd.to(dev), yd.to(dev)
        pd = params_from_numpy(params_to_numpy(pd), device=dev)
        loss_fn = make_objective("crps", model="fitc")
        sched = SCHEDULES[("kin40k_fitc", "crps")]
        walls = []
        for steps in WIDE_TIMED:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit_gd(loss_fn, pd, xd, yd, steps, sched.lr, sched.lr_inducing)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        per_step = (walls[1] - walls[0]) / (WIDE_TIMED[1] - WIDE_TIMED[0])
        _, _, top, _ = bench_ceiling.device_profile(
            lambda: fit_gd(loss_fn, pd, xd, yd, WIDE_TIMED[0], sched.lr, sched.lr_inducing))
        gram_us = {k: sum(sec for name, sec in top if f"gram_{k}" in name) / WIDE_TIMED[0] * 1e6
                   for k in ("fwd", "bwd_rows", "bwd_cols")}
        log(f"[wide] FITC-20 crps at d = {d}: {per_step * 1e6:.1f} us a replayed step "
            f"({WIDE_TIMED[1]} - {WIDE_TIMED[0]} steps); the Gram kernels' device us a step: "
            + ", ".join(f"{k} {v:.2f}" for k, v in gram_us.items()))

    # (b) The large-n step.
    x, y, _, _ = (v.to(dev) for v in large_n.make_data(LARGE_N, WIDE_D, LARGE_TEST))
    p0 = bench_wide.wide_params(WIDE_D, dev)
    xs = x * torch.exp(-p0.log_length)
    sig = torch.exp(p0.log_signal_sq)
    lo, hi = off_diagonal_span(gram_cuda.gram_fwd_cuda(xs[:F64_ROWS].contiguous(),
                                                       xs[:F64_ROWS].contiguous(), sig), sig)
    log(f"[wide] large n = {LARGE_N}, d = {WIDE_D}: K's first {F64_ROWS} rows off the diagonal "
        f"span {lo:.3g} to {hi:.3g}")
    del xs
    vg = bench_ceiling.value_and_grad
    gram_cuda.reset_launches()
    steps = {}
    for rule in WIDE_LARGE_RULES:
        steps[rule] = vg(make_objective(rule, model="exact"), p0, x, y)
    torch.cuda.synchronize()
    launches_large = dict(gram_cuda.LAUNCHES)
    assert all(v > 0 for v in launches_large.values()), launches_large
    # Timed and profiled before the float64 witness takes its ~3 n^2 * 8 B.
    recs = {rule: bench_wide.measure(rule, x, y, p0, repeats=1) for rule in WIDE_LARGE_RULES}
    torch.cuda.empty_cache()
    inverse = f64_inverse(x, y, p0)
    for rule in WIDE_LARGE_RULES:
        (v, g), limits, rec = steps[rule], WIDE_F64_GRAD_RTOL[rule], recs[rule]
        v64, g64 = f64_step0(rule, x, y, p0, inverse=inverse)
        rel = abs(float(v) - v64) / abs(v64)
        leaves = {f: grad_rel({f: g[f]}, {f: g64[f]}) for f in g64}
        torch.cuda.empty_cache()
        log(f"[wide] large n {rule} step 0 against float64 (loss {v64:.10g}): loss rel {rel:.3g} "
            f"(tol {LARGE_LOSS_RTOL}), grad rel by leaf "
            + ", ".join(f"{f} {e:.3g}" for f, e in leaves.items()) + f" (tol {limits}); step "
            f"{rec['step_s']:.4f} s, peak {rec['peak_n2']:.3f} n^2 * 4 B, device busy "
            f"{rec['busy_s']:.4f} s (ms by kind: "
            + ", ".join(f"{k} {ms:.1f}" for k, ms in rec["ms_by_kind"].items())
            + f"), the Gram backward {rec['gram_bwd_ms']:.2f} ms a step (peak limit "
            f"{PEAK_LIMIT_N2})")
        assert rel <= LARGE_LOSS_RTOL and all(e <= limits[f] for f, e in leaves.items()), \
            (rule, rel, leaves)
        assert rec["peak_n2"] <= PEAK_LIMIT_N2, (rule, rec["peak_n2"])
    del inverse
    torch.cuda.empty_cache()
    log(f"[wide] large n steps: kernel launches {launches_large}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, launches_large


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
    def phase(number, fn, *args):
        """Run a phase; log its wall time (the smoke runs under a time limit)."""
        t = time.perf_counter()
        out = fn(*args)
        log(f"[phase {number}] {fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    err, times = phase(3, phase_kernels, dev)
    launches = {"fitc": phase(4, phase_slice, dev)}
    phase(5, phase_pool, dev)
    launches["exact"] = phase(6, phase_exact, dev)
    phase(7, phase_drivers, dev)
    launches["large_n"], crps_fit = phase(8, phase_large_n, dev)
    launches["large_n_folds"] = phase(9, phase_folds, dev)
    launches["graph"] = phase(10, phase_graph, dev)
    launches["precision"], _ = phase(11, phase_precision, dev, crps_fit, times)
    launches["sweeps"], launches["sweeps_replicates"], err12, btimes = phase(12, phase_sweeps,
                                                                             dev)
    launches["analysis"], err13, atimes = phase(13, phase_analysis, dev)
    launches["sharded"], _ = phase(14, phase_mesh, dev)
    launches["sharded_fused"], _ = phase(15, phase_sharded_fused, dev)
    launches["results_parity"], err16, ptimes = phase(16, phase_results_parity, dev)
    launches["wide"], launches["wide_large_n"] = phase(17, phase_wide, dev)
    log(f"[phases] 1-17 in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, key in KERNELS:
        on_path = times[(name, *TIMED_SHAPES[0])]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": sum(c[key] for c in launches.values()),
                        "launches_by_path": {p: c[key] for p, c in launches.items()},
                        "max_abs_err": max(err[name], err12[name], err13[name], err16[name]),
                        "ms": on_path["ms"],
                        "plain_ms": on_path["plain_ms"], "bound_ms": on_path["bound_ms"],
                        "bound_by": on_path["bound_by"], "library_ms": None,
                        "shapes": {**{"x".join(map(str, s)): times[(name, *s)]
                                      for s in TIMED_SHAPES + FWD_SHAPES + CHUNK_SHAPES
                                      + MESH_BWD_SHAPES if (name, *s) in times},
                                   **{"x".join(map(str, k[1:4])) + "/" + k[4]: t
                                      for k, t in times.items() if k[0] == name and len(k) == 5},
                                   **{"x".join(map(str, k[1:5])): t for k, t in times.items()
                                      if k[0] == name and k[-1] == "batched"},
                                   **{shape: t[name] for shape, t in btimes.items()},
                                   **{shape: t[name] for shape, t in ptimes.items()},
                                   **{shape: t[name] for shape, t in atimes.items()
                                      if name in t}}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
