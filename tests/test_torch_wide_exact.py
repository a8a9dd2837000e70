"""The exact GP at a wide input (d = 90, past the Gram kernels' 64 floats)
through ``fit_gd``'s eager path and the fused cores, the benchmark's wide
driver on the CPU, and the Gram dispatchers' spans.

- ``fit_gd`` at n = 256, d = 90, block 64 (the fused threshold lowered to 1,
  as ``tests/test_torch_large_n.py`` lowers it), from the wide start
  (``gpbench.frozen.wide``: the log lengths raised by log(d / 8) / 2), for dss
  (the fold-streamed core) and crps (the fused LOO core): the losses of steps
  0-3 and the first gradient as applied, (theta_0 - theta_1) / rate, against
  the benchmark's float64 reference (``gpbench.reference``, plain torch, by
  hand in row blocks), which steps from the same start at the same rate.
- ``gpbench/entries/exact_steps_wide.py``'s run at n = 256 on the CPU: its
  check's numbers under the cell's limits.
- ``gram.fwd`` / ``gram.bwd``: one span a dispatcher call, with their
  attributes, only while torch.profiler records; on a card (``cuda``-marked)
  as many as the launches one d = 90 step counts.

Nothing here imports JAX; on a machine with a card and no JAX, run the
``cuda``-marked test with

    python -m pytest --noconftest -m cuda tests/test_torch_wide_exact.py -q
"""

import copy
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpbench import reference, spec
from gpbench.frozen import data as gen
from gpbench.frozen.wide import wide_params
from gpscore_torch.fit import fit_gd, make_objective
from gpscore_torch.fit import objectives as tobjectives
from gpscore_torch.ops import gram_cuda, loo_fused
from gpscore_torch.utils import profiling
from gpscore_torch.utils.params import GPParams

N, D, BLOCK, FOLD_K = 256, 90, 64, 4
CELL = "exact30k_d90_dss_folds"
# The cell's rates: crps 1.0; dss 0.001 scaled by 500 / n (a sum-scaled rule).
RATES = {"crps": 1.0, "dss": 0.001 * 500 / N}
STEPS = 4  # losses of steps 0-3, as the cell's check compares them

# fp32 against float64 at n = 256, read at seeds 3-5 for both rules: each
# loss is a mean (crps) or sum (dss) of per-site terms through an fp32
# inverse; the largest gap read is 8.6e-8 (crps step 0, seed 4), and 1e-6
# leaves over 10x room above it, still far under the 1e-3 of a loss altered
# by one part in a thousand.
LOSS_RTOL = 1e-6
# The first gradient, each leaf's largest entry gap over the leaf's largest
# entry: each length's gradient sums n^2 pairs' fp32 products of the inverse
# and K, the widest sum of the three leaves; the largest gap read is 9.3e-6
# (dss log_length, seed 3; the scalar leaves' at most 8.3e-7), and 1e-4 leaves
# over 10x room above it.
GRAD_RTOL = 1e-4


def _data(seed=3):
    x, y = gen.large_n_data(N, D, seed)
    return x, y


def _reference_losses_and_grad(rule, p0, x, y, lr):
    """The float64 reference's losses at steps 0..STEPS-1 (its own GD from
    p0) and its first gradient."""
    q = {k: v.double() for k, v in p0.items()}
    losses, g0 = [], None
    for i in range(STEPS):
        last = i == STEPS - 1
        v, g = reference.exact_value_grad(rule, q, x.double(), y.double(), FOLD_K, BLOCK,
                                          want_grad=not last)
        losses.append(float(v))
        if last:
            break
        g0 = g if g0 is None else g0
        q = {k: q[k] - lr * g[k] for k in q}
    return losses, g0


@pytest.mark.parametrize("rule", ["dss", "crps"])
def test_fit_gd_at_d90_matches_the_float64_reference(monkeypatch, rule):
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 1)
    x, y = _data()
    p0 = wide_params(D)
    lr = RATES[rule]
    loss = make_objective(rule, model="exact", fold_k=FOLD_K, block=BLOCK)
    before = dict(loo_fused.STREAM_BLOCKS)
    res = fit_gd(loss, GPParams(**p0), x, y, STEPS, lr, graph=False)
    one = fit_gd(loss, GPParams(**p0), x, y, 1, lr, graph=False)
    passes = FOLD_K if rule == "dss" else 1
    # Through the fused cores: each of the 5 steps streamed its passes' row blocks.
    assert loo_fused.STREAM_BLOCKS["lower"] - before["lower"] == 5 * passes * N // BLOCK
    ref_losses, g0 = _reference_losses_and_grad(rule, p0, x, y, lr)
    got = [float(v) for v in res.loss_history]
    for step, (g, r) in enumerate(zip(got, ref_losses)):
        assert abs(g - r) <= LOSS_RTOL * abs(r), (step, g, r)
    applied = {k: (p0[k].double() - v.double()) / lr for k, v in one.params.leaves().items()}
    for k, want in g0.items():
        scale = float(want.abs().max())
        assert scale > 0 and float((applied[k] - want).abs().max()) <= GRAD_RTOL * scale, k


def _shrunk_cell():
    cell = copy.deepcopy(spec.load_cell(CELL))
    cell.config["n"] = N
    return cell


@pytest.mark.parametrize("seed", [2 ** 31 + 12345, 987654321012])
def test_the_wide_driver_is_correct_on_the_cpu(monkeypatch, seed):
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 128)
    cell = _shrunk_cell()
    run = spec.load_entry(cell.traffic["entry"]).Run(cell, seed, torch.device("cpu"))
    run.setup()
    assert torch.equal(run.p0["log_length"], wide_params(D)["log_length"])
    values = run.window(0.0)
    assert run.N == cell.traffic["check"]["steps"] and values["exact_step_s"] > 0
    run.release()
    readings = run.check()
    limits = cell.traffic["check"]["limits"]
    assert set(limits) <= set(readings)
    for name, limit in limits.items():
        assert math.isfinite(readings[name]) and readings[name] <= limit, (name, readings[name])


# ---- the Gram dispatchers' spans ------------------------------------------


def _new(before):
    return [r for r in profiling.spans()[0] if r.id >= before]


def _inputs(d, n=24, m=10, batch=None):
    g = torch.Generator().manual_seed(d)
    lead = () if batch is None else (batch,)
    xs = torch.randn((*lead, n, d), generator=g) / math.sqrt(d)
    xps = torch.randn((*lead, m, d), generator=g) / math.sqrt(d)
    cot = torch.randn((*lead, n, m), generator=g)
    return xs, xps, torch.tensor(1.3), cot


@pytest.mark.parametrize("d,chunked", [(8, False), (90, True)])
@pytest.mark.parametrize("batch", [None, 3])
def test_each_gram_dispatch_is_one_span_with_its_attributes(d, chunked, batch):
    xs, xps, sig, cot = _inputs(d, batch=batch)
    before = profiling._LOG.next_id
    with profile(activities=[ProfilerActivity.CPU]):
        K = gram_cuda.gram_fwd(xs, xps, sig)
        gram_cuda.gram_bwd(xs, xps, sig, cot)
    fwd, bwd = _new(before)
    shape = {"n": 24, "m": 10, "d": d, "batch": batch, "chunked": chunked}
    assert fwd.name == "gram.fwd"
    assert fwd.attrs == {"kernel": "fwd_dchunk" if chunked else "fwd", **shape}
    assert bwd.name == "gram.bwd" and bwd.attrs == {"kernel": ("bwd_rows", "bwd_cols"), **shape}
    assert fwd.end_ns <= bwd.start_ns
    assert fwd.device_ms is None and bwd.device_ms is None  # the CPU's: host only
    torch.testing.assert_close(K, gram_cuda.gram_fwd_plain(xs, xps, sig), rtol=0, atol=0)


def test_gram_spans_record_nothing_with_the_profiler_off():
    assert not torch.autograd._profiler_enabled()
    xs, xps, sig, cot = _inputs(90)
    # the one shared null context every span returns while nothing records
    assert gram_cuda._span("gram.fwd", xs, xps) is profiling.span("fit")
    before = profiling._LOG.next_id
    gram_cuda.gram_fwd(xs, xps, sig)
    gram_cuda.gram_bwd(xs, xps, sig, cot)
    assert profiling._LOG.next_id == before


def _dss_step_spans(x, y, steps, block):
    """The spans of a traced eager dss fit of ``steps`` steps at ``block``."""
    loss = make_objective("dss", model="exact", fold_k=FOLD_K, block=block)
    before = profiling._LOG.next_id
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if x.is_cuda else [])
    with profile(activities=acts):
        fit_gd(loss, GPParams(**{k: v.to(x.device) for k, v in wide_params(D).items()}),
               x, y, steps, RATES["dss"], graph=False)
    return _new(before)


def test_a_d90_dss_step_spans_one_forward_and_one_backward_a_row_block(monkeypatch):
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 1)
    x, y = _data()
    recs = _dss_step_spans(x, y, 2, BLOCK)
    (fit,) = [r for r in recs if r.name == "fit"]
    fwd = [r for r in recs if r.name == "gram.fwd"]
    bwd = [r for r in recs if r.name == "gram.bwd"]
    blocks = FOLD_K * N // BLOCK
    assert len(fwd) == 2 and len(bwd) == 2 * blocks
    assert all(r.root == fit.id and r.attrs["chunked"] for r in fwd + bwd)
    assert {r.attrs["kernel"] for r in fwd} == {"fwd_dchunk"}
    assert {(r.attrs["n"], r.attrs["m"]) for r in fwd} == {(N, N)}
    # the backward's row blocks [r0, r1) against the columns [0, r1), each fold's pass
    assert sorted((r.attrs["n"], r.attrs["m"]) for r in bwd) == \
        sorted([(BLOCK, r1) for r1 in range(BLOCK, N + 1, BLOCK)] * (2 * FOLD_K))


@pytest.mark.cuda
def test_the_gram_spans_of_a_d90_step_equal_its_launches(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the d-chunked kernels run only on a card")
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 1)
    dev = torch.device("cuda", 0)
    n, block = 4096, 1024
    x, y = (t.to(dev) for t in gen.large_n_data(n, D, 5))
    _dss_step_spans(x, y, 1, block)  # warm: kernels, workspaces, the profiler
    before = dict(gram_cuda.LAUNCHES)
    recs = _dss_step_spans(x, y, 1, block)
    delta = {k: v - before[k] for k, v in gram_cuda.LAUNCHES.items()}
    fwd = [r for r in recs if r.name == "gram.fwd"]
    bwd = [r for r in recs if r.name == "gram.bwd"]
    assert delta == {"fwd": 0, "fwd_dchunk": len(fwd), "bwd_rows": len(bwd),
                     "bwd_cols": len(bwd)}
    assert len(fwd) == 1 and len(bwd) == FOLD_K * n // block
    assert all(r.device_ms is not None and r.device_ms > 0 for r in fwd + bwd)
