"""Smoke run of the PyTorch/CUDA port (gpscore_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, none of whose failures is caught:

1. Device: exits non-zero without CUDA; prints the card's name and power limit.
2. Build: compiles gpscore_torch/csrc/ with nvcc (first use) and prints the
   compiler's register/spill report and the build time.
3. Kernels against their plain PyTorch versions, on the card, at the main
   path's shapes (500x20x8, 20x20x8), the evaluation's (500x500x8), the full
   pool's (9700x20x8), ragged and tall-skinny ones that exercise the column
   kernel's row chunks, and d = 64; two calls of each kernel on the same
   inputs must be bitwise equal. Then, at 500x20x8, 500x500x8 and 9700x20x8,
   kernel and plain times per call (CUDA events, back to back) and device
   time per call (torch.profiler's CUDA events, summed).
4. The slice: the five-rule KIN40K FITC-20 fit (n = 500, d = 8, m = 20) from
   the committed initial parameters, 25 GD steps per rule through fit_gd on
   CUDA, then the test-set evaluation. The kernels' launch counters are zeroed
   just before and read just after. At every step the loss and gradient on
   CUDA are held against the CPU's at the same parameters, the loop's update
   is checked, and a free-running CPU fit is compared with the CUDA one.
5. A real-size step: five crps steps on the full 9700-row pool.

The line before the last is the card's ``nvidia-smi`` name and power limit;
before it, one JSON line describes every kernel: ``ms`` and ``plain_ms`` at
the main path's 500x20x8, and under ``shapes`` the per-call and device times
at every timed shape. The last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import gpscore_torch
from gpscore_torch.data import kin40k_fitc20_init, kin40k_replicate_split, load_kin40k
from gpscore_torch.fit import SCHEDULES, eval_predictive_metrics, fit_gd, make_objective
from gpscore_torch.ops import _build, gram_cuda
from gpscore_torch.utils import params_from_numpy, params_to_numpy

RULES = ["crps", "nlml", "logs", "dss", "kc"]
SOURCE = "gpscore_torch/csrc/gram.cu"
REPLACES = {
    "gram_fwd": "gpscore/ops/gram_pallas.py:40",  # _gram_kernel
    "gram_bwd_rows": "gpscore/ops/gram_pallas.py:116",  # _bwd
    "gram_bwd_cols": "gpscore/ops/gram_pallas.py:116",  # _bwd
}
KERNEL_SHAPES = [(500, 20, 8), (20, 20, 8), (500, 500, 8), (9700, 20, 8),
                 (4099, 1031, 8), (257, 33, 1), (9700, 1, 8), (9701, 33, 8),
                 (40000, 20, 8), (9700, 20, 64)]
TIMED_SHAPES = [(500, 20, 8), (500, 500, 8), (9700, 20, 8)]
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


def log(*a):
    print(*a, flush=True)


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


def device_ms(fn, reps=50, warmup=5):
    """Device time per call of ``fn``: torch.profiler's CUDA events (kernels,
    copies, sets), summed over ``reps`` calls. A profiled window that records
    no device event at all (it happens, rarely, on the card's machine) is
    taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3
    raise RuntimeError("three profiled windows saw no device work")


def kernel_inputs(n, m, d, dev, seed):
    """Scaled inputs as the main path makes them: KIN40K-like x in [-1, 1],
    log lengths in [0, 1], sig = e; xps = xs for the square K(u, u) case."""
    rng = np.random.default_rng(seed)
    ll = rng.uniform(0.0, 1.0, d).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    xp = x if (n, m) == (20, 20) else rng.uniform(-1.0, 1.0, (m, d)).astype(np.float32)
    inv = np.exp(-ll)
    xs = torch.tensor(x * inv, device=dev)
    xps = torch.tensor(xp * inv, device=dev)
    g = torch.tensor(rng.standard_normal((n, m)).astype(np.float32), device=dev)
    return xs, xps, torch.tensor(np.e, dtype=torch.float32, device=dev), g


def phase_kernels(dev):
    err = {k: 0.0 for k in REPLACES}
    for s, (n, m, d) in enumerate(KERNEL_SHAPES):
        xs, xps, sig, g = kernel_inputs(n, m, d, dev, seed=s)
        K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
        Kp = gram_cuda.gram_fwd_plain(xs, xps, sig)
        e_f = float((K - Kp).abs().max())
        assert torch.isfinite(K).all() and e_f <= FWD_ATOL, (n, m, d, e_f)
        if (n, m) == (20, 20):
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
    times = {}
    for n, m, d in TIMED_SHAPES:
        xs, xps, sig, g = kernel_inputs(n, m, d, dev, seed=99)
        pairs = {
            "gram_fwd": (lambda: gram_cuda.gram_fwd_cuda(xs, xps, sig),
                         lambda: gram_cuda.gram_fwd_plain(xs, xps, sig)),
            "gram_bwd_rows": (lambda: gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g),
                              lambda: gram_cuda.gram_bwd_rows_plain(xs, xps, sig, g)),
            "gram_bwd_cols": (lambda: gram_cuda.gram_bwd_cols_cuda(xs, xps, sig, g),
                              lambda: gram_cuda.gram_bwd_cols_plain(xs, xps, sig, g)),
        }
        for name, (kern, plain) in pairs.items():
            # Plain, kernel, kernel, plain: drift in clocks hits both alike.
            p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
            t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                 "device_ms": device_ms(kern), "plain_device_ms": device_ms(plain)}
            times[(name, n, m, d)] = t
            log(f"[time] {name} {n}x{m}x{d}: per call kernel {t['ms']:.5f} ms, plain "
                f"{t['plain_ms']:.5f} ms; device time per call kernel {t['device_ms']:.5f} "
                f"ms, plain {t['plain_device_ms']:.5f} ms")
    return err, times


def leaves_of(p, i=None):
    return {f: (t if i is None else t[i]) for f, t in p.leaves().items()}


def loss_and_grad(loss_fn, params, leaves, x, y):
    cur = {f: t.detach().clone().requires_grad_() for f, t in leaves.items()}
    loss = loss_fn(params.replace(**cur), x, y)
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
    log(_build.build_report().rstrip())
    err, times = phase_kernels(dev)
    launches = phase_slice(dev)
    phase_pool(dev)
    kernels = []
    for name, key in [("gram_fwd", "fwd"), ("gram_bwd_rows", "bwd_rows"),
                      ("gram_bwd_cols", "bwd_cols")]:
        on_path = times[(name, *TIMED_SHAPES[0])]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name], "launches": launches[key],
                        "max_abs_err": err[name], "ms": on_path["ms"],
                        "plain_ms": on_path["plain_ms"],
                        "shapes": {"x".join(map(str, s)): times[(name, *s)]
                                   for s in TIMED_SHAPES}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
