"""FITC fits of a configuration's rules, one after another, repeated.

The timed path is the users' main path (``python -m gpscore_torch.bench``):
per rule ``fit_gd`` of ``make_objective(rule, model="fitc")`` (one restart),
or ``restart_sweep`` (R restarts as one batched fit), at the rule's
schedule, with ``fit_gd``'s default on a card: three eager steps, one
captured step, replays.

- set-up: the data and each rule's initial parameters from the seed, then
  every rule's fit at ``warmup_iters`` iterations (its shapes, its capture);
- window: whole five-rule fits back to back, each from the initial
  parameters; a fit starts only if the fits so far say it ends inside the
  window. ``fitc_fit_s`` is the window's time over its fits;
- trace: per rule, fits of ``profile_short_iters`` and of
  ``profile_replays`` more iterations under torch.profiler: their
  difference is replays alone (``gpscore_torch/bench.py``'s
  ``profile_replayed``). A whole fit's millions of device events would take
  minutes to reduce, and the profiler drops some of them;
- check: every fit's first ``check.steps`` losses (every restart's) against
  the float64 reference's own GD from the same start (:mod:`gpbench.reference`),
  and each rule's first gradient as its update applied it, (theta_0 -
  theta_1) / rate, leaf by leaf (the inducing points at their own rate),
  against the reference's first gradient. theta_1 comes from a one-step fit
  of the same call in set-up.
"""

from __future__ import annotations

import sys
import time

from gpbench import reference, trace as tr
from gpbench.entries.common import norm_gap, program_mode, sync
from gpbench.frozen import data as gen
from gpbench.frozen.fitc_flop import fitc_step_flop
from gpbench.frozen.gram_roofline import roofline
from gpbench.frozen.peaks import H100_FP32_FLOP_PER_S


class Run:
    kind = "fitc"

    def __init__(self, cell, seed: int, device, mode=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.mode = mode or self.traffic.get("precision", self.cfg.get("precision", "highest"))
        self.rules = list(self.traffic["rules"])
        self.R = int(self.traffic.get("restarts", 1))
        self.K = int(self.traffic["check"]["steps"])

    # ---- the program ----------------------------------------------------

    def _inducing_init(self, rule):
        init = self.traffic["init"]["inducing"]
        return init.get(rule, init["*"])

    def setup(self):
        import torch
        from gpscore_torch.fit import make_objective

        cfg, d = self.cfg, self.cfg["d"]
        X, Y = gen.synthesize_kin40k_like(self.seed, cfg["data"]["n_pool"],
                                          cfg["data"]["n_test"], d)
        x, y = gen.kin40k_replicate_split(X, Y, cfg["data"]["replicate"], cfg["n_train"],
                                          cfg["data"]["n_va"])
        self.x = torch.as_tensor(x, device=self.device)
        self.y = torch.as_tensor(y, device=self.device)
        self.p0, self.objs = {}, {}
        for rule in self.rules:
            g = torch.Generator().manual_seed(gen.torch_seed(self.seed))
            leaves = gen.init_rand_params(g, d, cfg["num_inducing"],
                                          unit_scalars=self.traffic["init"]["unit_scalars"],
                                          inducing_init=self._inducing_init(rule),
                                          batch=None if self.R == 1 else self.R)
            self.p0[rule] = {k: v.to(self.device) for k, v in leaves.items()}
            self.objs[rule] = make_objective(rule, model="fitc", fold_k=cfg["fold_k"])
        for rule in self.rules:
            self.fit(rule, self.traffic["warmup_iters"])
        self.theta1 = {rule: {k: v.double().cpu() for k, v in self.fit(rule, 1).params.leaves()
                              .items()} for rule in self.rules}
        sync(self.device)

    def fit(self, rule, iters=None):
        from gpscore_torch.fit import fit_gd
        from gpscore_torch.parallel import restart_sweep
        from gpscore_torch.utils.params import GPParams

        s = self.cfg["schedules"][rule]
        it = s["iters"] if iters is None else min(iters, s["iters"])
        p = GPParams(**self.p0[rule])
        with program_mode(self.mode):
            if self.R == 1:
                return fit_gd(self.objs[rule], p, self.x, self.y, it, s["lr"], s["lr_inducing"])
            return restart_sweep(self.objs[rule], p, self.x, self.y, it, s["lr"],
                                 s["lr_inducing"])

    def window(self, seconds: float) -> dict:
        self.heads, stalls, ends = [], [], []
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            done = len(self.heads)
            elapsed = time.perf_counter() - t0
            if done and elapsed * (done + 1) / done > seconds:
                break
            head, stall = {}, {}
            for rule in self.rules:
                res = self.fit(rule)
                head[rule] = res.loss_history[..., :self.K].clone()
                stall[rule] = res.stall_iters
            sync(self.device)
            self.heads.append(head)
            stalls.append(stall)
            ends.append(time.perf_counter() - t0)
        self.window_s = ends[-1]
        print("[gpbench] seconds a fit:", [b - a for a, b in zip([0.0] + ends, ends)],
              file=sys.stderr, flush=True)
        self.fits = len(self.heads)
        self.attempted = self.fits * len(self.rules) * self.R
        self.failed = sum(int((s[r] > 0).sum()) for s in stalls for r in self.rules)
        return {"fitc_fit_s": self.window_s / self.fits}

    def trace(self) -> dict:
        from gpscore_torch.ops.gram_cuda import LAUNCHES

        short = int(self.traffic["profile_short_iters"])
        long = short + int(self.traffic["profile_replays"])
        rules = {}
        for rule in self.rules:
            s_span, s_takes, s_ok = tr.profile_complete(lambda: self.fit(rule, short), LAUNCHES)
            l_span, l_takes, l_ok = tr.profile_complete(lambda: self.fit(rule, long), LAUNCHES)
            rules[rule] = {"iters": self.cfg["schedules"][rule]["iters"], "short": short,
                           "long": min(long, self.cfg["schedules"][rule]["iters"]),
                           "short_span": s_span, "long_span": l_span, "complete": s_ok and l_ok,
                           "takes": s_takes + l_takes}
        self.trace_data = {"kind": "fitc", "rules": rules, "steps_bound_us": self.step_gram_bound_us(),
                           "window_s": self.window_s, "fits": self.fits,
                           "window_flop": self.window_flop()}
        self.traced_spans = [span for r in rules.values() for span in (r["short_span"],
                                                                       r["long_span"])]
        return self.trace_data

    # ---- counts of the math ---------------------------------------------

    def step_gram_bound_us(self) -> float:
        """The roofline bound of one step's Gram calls: K(x, u) and K(u, u),
        forward and both backward halves, R of each in one call."""
        n, m, d = self.cfg["n_train"], self.cfg["num_inducing"], self.cfg["d"]
        total = 0.0
        for kernel in ("gram_fwd", "gram_bwd_rows", "gram_bwd_cols"):
            total += roofline(kernel, n, m, d, batch=self.R).bound_us
            total += roofline(kernel, m, m, d, batch=self.R, shared_x=True).bound_us
        return total

    def window_flop(self) -> float:
        n, m, d, k = (self.cfg[key] for key in ("n_train", "num_inducing", "d", "fold_k"))
        per_fit = sum(fitc_step_flop(r, n, m, d, k) * self.cfg["schedules"][r]["iters"]
                      for r in self.rules)
        return per_fit * self.R * self.fits

    def mfu(self) -> float:
        return self.window_flop() / self.window_s / H100_FP32_FLOP_PER_S

    # ---- the check ------------------------------------------------------

    def release(self):
        import torch

        self.heads = [{r: h.double().cpu() for r, h in head.items()} for head in self.heads]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _rate(self, rule, leaf):
        s = self.cfg["schedules"][rule]
        return s["lr_inducing"] if leaf == "inducing" else s["lr"]

    def check(self) -> dict:
        import torch

        x = self.x.double()
        y = self.y.double()
        gaps, grads = {}, []  # rule -> loss gaps [fits, R, K]; (rule, leaf, gap) a restart
        for rule in self.rules:
            q = {k: v.double() for k, v in self.p0[rule].items()}
            ref = []
            for step in range(self.K):
                v, g = reference.fitc_value_grad(rule, q, x, y, self.cfg["fold_k"])
                ref.append(v.cpu())
                if step == 0:
                    grads += self._grad_gaps(rule, {k: t.cpu() for k, t in g.items()})
                q = {k: q[k] - self._rate(rule, k) * g[k] for k in q}
            ref = torch.stack(ref, dim=-1).reshape(self.R, self.K)
            prog = torch.stack([head[rule].reshape(self.R, self.K) for head in self.heads])
            gap = (prog - ref).abs() / ref.abs().clamp_min(1e-300)
            gap = torch.where(torch.isfinite(prog), gap, torch.inf)
            gaps[rule] = torch.where(torch.isfinite(ref), gap,
                                     torch.where(torch.isfinite(prog), torch.inf, 0.0))
        every = torch.stack([gaps[r] for r in self.rules])  # [rules, fits, R, K]
        out = {"loss_rel": every.max(),
               "loss_rel_rms": every.square().mean().sqrt(),
               "loss_rel_step0": every[..., 0].max(),
               # the restart whose losses read furthest off, over every rule, fit and step
               "loss_rel_rms_restart": every.square().mean(dim=(0, 1, 3)).sqrt().max()}
        for rule in self.rules:
            out[f"loss_rel_{rule}"] = gaps[rule].max()
            out[f"loss_rel_rms_{rule}"] = gaps[rule].square().mean().sqrt()
        for key in dict.fromkeys([leaf for _, leaf, _ in grads] + self.rules):
            out[f"grad_{key}"] = max(gap for rule, leaf, gap in grads if key in (rule, leaf))
        out["grad_rel"] = max(gap for _, _, gap in grads)
        return {k: float(v) for k, v in out.items()}

    def _grad_gaps(self, rule, g0):
        """Each leaf's gap of norms, per restart, between the first gradient
        the program applied and the reference's, over the larger of the
        reference's norm and the median leaf's. A leaf whose reference
        gradient is under a thousandth of the median leaf's moves by
        round-off alone and is left out."""
        import statistics

        import torch

        def norms(t):
            return torch.linalg.vector_norm(t.reshape(self.R, -1), dim=1).tolist()

        p0 = {k: v.double().cpu() for k, v in self.p0[rule].items()}
        prog = {k: norms((p0[k] - self.theta1[rule][k]) / self._rate(rule, k)) for k in p0}
        ref = {k: norms(g0[k]) for k in p0}
        out = []
        for r in range(self.R):
            median = statistics.median(ref[k][r] for k in p0)
            out += [(rule, k, norm_gap(prog[k][r], ref[k][r], max(ref[k][r], median)))
                    for k in p0 if ref[k][r] >= 1e-3 * median]
        return out
