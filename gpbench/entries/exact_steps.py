"""GD steps of the exact GP at large n, as ``experiments/large_n.py`` fits it.

The timed path is ``fit_gd(make_objective(rule, model="exact"), ...,
graph=False)``: from the objectives' threshold on, crps, logs and nlml take
the fused cores (``ops/loo_fused.py``) and the fold rules the fold-streamed
ones (``ops/fold_stream.py``).

- set-up: the data from the seed, unit parameters, and one GD step of that
  call (its shapes, cuBLAS and cuSOLVER handles, workspaces); it is the
  fit's first step, and its parameters start the window;
- window: one call of ``fit_gd`` for N further steps, N as many as the warm
  step's time says fit in the window (at least the steps the check
  compares). ``exact_step_s`` is its time over N;
  ``exact_peak_gib`` the allocator's peak over it;
- trace: ``trace_steps`` more steps under torch.profiler, retaken until the
  Gram events recorded equal the launches counted;
- check: the float64 reference's own three GD steps from the unit start
  (:mod:`gpbench.reference`, in row blocks) against the program's first
  losses, and its first gradient against the one the warm step applied.
"""

from __future__ import annotations

import math
import statistics
import time

from gpbench import reference, trace as tr
from gpbench.entries.common import norm_gap, program_mode, rel_gap, sync
from gpbench.frozen import data as gen
from gpbench.frozen.gram_roofline import roofline
from gpbench.frozen.peaks import H100_FP32_FLOP_PER_S
from gpbench.frozen.step_flop import FOLD_RULES, step_flop

LEAVES = ("log_signal_sq", "log_length", "log_noise_sq")


class Run:
    kind = "exact"

    def __init__(self, cell, seed: int, device, mode=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.mode = mode or self.traffic.get("precision", self.cfg.get("precision", "highest"))
        self.rule = self.traffic["rule"]
        n = self.cfg["n"]
        base = self.cfg["lr"][self.rule]
        self.lr = base * self.cfg["lr_reference_n"] / n if self.rule in self.cfg["lr_sum_scaled"] \
            else base

    def setup(self):
        import torch
        from gpscore_torch.fit import make_objective
        from gpscore_torch.ops.loo_fused import auto_block

        x, y = gen.large_n_data(self.cfg["n"], self.cfg["d"], self.seed)
        self.x, self.y = x.to(self.device), y.to(self.device)
        self.p0 = {k: v.to(self.device) for k, v in gen.unit_params(self.cfg["d"]).items()}
        # The program's own choice (on the CPU, whose budget it takes as
        # unbounded, its widest divisor); the reference streams in the same.
        self.block = auto_block(self.cfg["n"], device=self.device)
        self.obj = make_objective(self.rule, model="exact", fold_k=self.cfg["fold_k"],
                                  block=self.block)
        t0 = time.perf_counter()
        self.warm = self.steps(self.p0, 1)
        sync(self.device)
        self.warm_s = time.perf_counter() - t0
        self.setup_peak = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0

    def steps(self, leaves, iters):
        from gpscore_torch.fit import fit_gd
        from gpscore_torch.utils.params import GPParams

        with program_mode(self.mode):
            return fit_gd(self.obj, GPParams(**leaves), self.x, self.y, iters, self.lr,
                          graph=False)

    def window(self, seconds: float) -> dict:
        import torch

        # At least the steps the check compares.
        self.N = max(int(self.traffic["check"]["steps"]), int(seconds / self.warm_s))
        start = self.warm.params.leaves()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        sync(self.device)
        t0 = time.perf_counter()
        self.res = self.steps(start, self.N)
        sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        losses = self.res.loss_history
        self.attempted = self.N
        self.failed = int((~torch.isfinite(losses)).sum())
        return {"exact_step_s": self.window_s / self.N, "exact_peak_gib": self.peak / 2 ** 30}

    def trace(self) -> dict:
        from gpscore_torch.ops.gram_cuda import LAUNCHES

        S = int(self.traffic["trace_steps"])
        start = self.res.params.leaves()
        span, takes, ok = tr.profile_complete(lambda: self.steps(start, S), LAUNCHES)
        self.traced_spans = [span]
        self.trace_data = {"kind": "exact", "span": span, "steps": S, "complete": ok,
                           "takes": takes, "launches_expected": self.step_launches(S),
                           "steps_bound_us": self.step_gram_bound_us(),
                           "window_s": self.window_s, "window_steps": self.N,
                           "step_flop": step_flop(self.rule, self.cfg["n"], self.cfg["fold_k"])}
        return self.trace_data

    # ---- counts of the math ---------------------------------------------

    def _blocks(self) -> int:
        n = self.cfg["n"]
        passes = self.cfg["fold_k"] if self.rule in FOLD_RULES else 1
        return passes * -(-n // self.block)

    def step_launches(self, steps: int) -> dict:
        """The Gram calls of ``steps`` steps: the forward on all of K_hat, and
        the backward's two halves once a row block of each streamed pass."""
        b = self._blocks() * steps
        return {"fwd": steps, "bwd_rows": b, "bwd_cols": b}

    def step_gram_bound_us(self) -> float:
        n, d, blk = self.cfg["n"], self.cfg["d"], self.block
        total = roofline("gram_fwd", n, n, d, shared_x=True).bound_us
        per_pass_rows = [min(blk, n - r0) for r0 in range(0, n, blk)]
        passes = self._blocks() // len(per_pass_rows)
        for rows in per_pass_rows:
            for kernel in ("gram_bwd_rows", "gram_bwd_cols"):
                total += passes * roofline(kernel, rows, n, d).bound_us
        return total

    def mfu(self) -> float:
        flop = step_flop(self.rule, self.cfg["n"], self.cfg["fold_k"]) * self.N
        return flop / self.window_s / H100_FP32_FLOP_PER_S

    # ---- the check ------------------------------------------------------

    def release(self):
        import torch

        w, r = self.warm, self.res
        self.prog_losses = [float(w.loss_history[0])] + \
            [float(v) for v in r.loss_history[:self.traffic["check"]["steps"]]]
        self.theta1 = {k: v.double().cpu() for k, v in w.params.leaves().items()}
        del self.warm, self.res
        self.obj = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        import torch

        x, y = self.x.double(), self.y.double()
        del self.x, self.y
        q = {k: v.double() for k, v in self.p0.items()}
        ref_losses, g0 = [], None
        for i in range(len(self.prog_losses)):
            last = i == len(self.prog_losses) - 1
            v, g = reference.exact_value_grad(self.rule, q, x, y, self.cfg["fold_k"],
                                              self.block, want_grad=not last)
            ref_losses.append(float(v))
            if last:
                break
            if g0 is None:
                g0 = {k: t.cpu() for k, t in g.items()}
            q = {k: q[k] - self.lr * g[k] for k in q}
        gaps = [rel_gap(p, r) for p, r in zip(self.prog_losses, ref_losses)]
        out = {"loss_rel": max(gaps)}
        out.update({f"loss_rel_step{i}": g for i, g in enumerate(gaps)})
        # The first gradient as the update applied it: (theta_0 - theta_1) / lr.
        p0 = {k: v.double().cpu() for k, v in self.p0.items()}
        prog = {k: float(torch.linalg.vector_norm((p0[k] - self.theta1[k]) / self.lr))
                for k in LEAVES}
        ref = {k: float(torch.linalg.vector_norm(g0[k])) for k in LEAVES}
        median = statistics.median(ref.values())
        for k in LEAVES:
            out[f"grad_{k}"] = norm_gap(prog[k], ref[k], max(ref[k], median))
        out["grad_worst"] = max(out[f"grad_{k}"] for k in LEAVES)
        return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
