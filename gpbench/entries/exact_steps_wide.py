"""GD steps of the exact GP at large n on wide inputs (d past 64 floats).

:mod:`gpbench.entries.exact_steps`' run, from the same ``fit_gd(...,
graph=False)`` call, window, trace and check, but for two things:

- it starts from the wide parameters (:mod:`gpbench.frozen.wide`: the log
  lengths raised by log(d / 8) / 2), in the program and in the reference's
  check alike; from unit lengths at d = 90, K(x, x) is near the identity
  (nowhere 1% of the signal variance off its diagonal) and the check would
  compare little of the kernel;
- it counts the forward under the launch counter's key the program uses past
  64 floats ("fwd_dchunk"), so that the Gram events' guard compares the
  kernel that ran.

Its trace data also carries the bound of a step's d-chunked Gram calls as the
math needs them since the backward streams the lower block-triangle: the
forward over all of K_hat once, and both backward halves on each row block
[r0, r1) against the columns [0, r1), once a streamed pass
(``dchunk_bound_us``, frozen ``gram_roofline``), and the program's Gram spans
a step (``gram_spans_per_step``), which the ``dchunk_gram_*`` readers hold
the span log to.
"""

from __future__ import annotations

import time

from gpbench.entries import exact_steps
from gpbench.entries.common import sync
from gpbench.frozen import data as gen
from gpbench.frozen.gram_roofline import roofline
from gpbench.frozen.wide import wide_params

# The widest d of the program's unchunked fp32 Gram kernels (MAX_D floats).
MAX_UNCHUNKED_D = 64


class Run(exact_steps.Run):

    def setup(self):
        import torch
        from gpscore_torch.fit import make_objective
        from gpscore_torch.ops.loo_fused import auto_block

        x, y = gen.large_n_data(self.cfg["n"], self.cfg["d"], self.seed)
        self.x, self.y = x.to(self.device), y.to(self.device)
        self.p0 = {k: v.to(self.device) for k, v in wide_params(self.cfg["d"]).items()}
        self.block = auto_block(self.cfg["n"], device=self.device)
        self.obj = make_objective(self.rule, model="exact", fold_k=self.cfg["fold_k"],
                                  block=self.block)
        t0 = time.perf_counter()
        self.warm = self.steps(self.p0, 1)
        sync(self.device)
        self.warm_s = time.perf_counter() - t0
        self.setup_peak = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0

    def trace(self) -> dict:
        data = super().trace()
        data["dchunk_bound_us"] = self.dchunk_bound_us()
        data["gram_spans_per_step"] = {"gram.fwd": 1, "gram.bwd": self._blocks()}
        return data

    def step_launches(self, steps: int) -> dict:
        """The Gram launches of ``steps`` steps, the forward under the key of
        the kernel the program launches at this width."""
        out = super().step_launches(steps)
        if self.cfg["d"] > MAX_UNCHUNKED_D:
            out["fwd_dchunk"] = out.pop("fwd")
        return out

    def dchunk_bound_us(self) -> float:
        """The roofline bound of one step's d-chunked Gram calls: the forward
        over all of K_hat, and both backward halves on each row block [r0, r1)
        against the columns [0, r1), once a streamed pass. 0 where d takes
        the unchunked kernels."""
        n, d, blk = self.cfg["n"], self.cfg["d"], self.block
        if d <= MAX_UNCHUNKED_D:
            return 0.0
        total = roofline("gram_fwd_dchunk", n, n, d, shared_x=True).bound_us
        starts = range(0, n, blk)
        passes = self._blocks() // len(starts)
        for r0 in starts:
            r1 = min(r0 + blk, n)
            for kernel in ("gram_bwd_rows", "gram_bwd_cols"):
                total += passes * roofline(kernel, r1 - r0, r1, d).bound_us
        return total
