"""The program's spans (gpscore_torch.utils.profiling.span): off unless
torch.profiler records, the GD loop's and the large-n cores' sites with
their parents, roots and counts, the bounded log, the clock they share with
the profiler's host events, and the Chrome trace that carries them.

The ``cuda``-marked tests need a card and skip without one; on a machine
with a card and no JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py -q

Nothing here imports JAX.
"""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpscore_torch.fit import fit_gd, fit_optim, make_objective
from gpscore_torch.fit import train
from gpscore_torch.ops import fold_stream, loo_fused
from gpscore_torch.utils import profiling
from gpscore_torch.utils.params import init_rand_params


def _fitc(device="cpu", n=48, m=6, d=3, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n, d), generator=g, device=device)
    y = torch.sin(x.sum(dim=1))
    return x, y, init_rand_params(g, d, m, unit_scalars=True)


def _new(before):
    """The spans finished since ``before`` (a span id)."""
    recs, _ = profiling.spans()
    return [r for r in recs if r.id >= before]


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_span_records_nothing_with_tracing_off():
    assert not torch.autograd._profiler_enabled()
    before = profiling._LOG.next_id
    # One shared null context: nothing is made per call.
    assert profiling.span("fit.eager", steps=3) is profiling.span("core.forward")
    x, y, p = _fitc()
    fit_gd(make_objective("crps", model="fitc"), p, x, y, 4, 1e-2)
    assert profiling._LOG.next_id == before and _new(before) == []


def test_fit_gd_records_the_fit_and_its_eager_steps_on_the_cpu():
    x, y, p = _fitc()
    before = profiling._LOG.next_id
    with profile(activities=[ProfilerActivity.CPU]):
        fit_gd(make_objective("crps", model="fitc"), p, x, y, 5, 1e-2)
    recs = _new(before)
    (fit,), (eager,) = _by_name(recs, "fit"), _by_name(recs, "fit.eager")
    assert fit.attrs == {"objective": "crps_fitc_objective", "iters": 5, "batch": None,
                         "graph": False}
    assert fit.parent is None and fit.root == fit.id
    assert eager.attrs == {"steps": 5}
    assert eager.parent == fit.id and eager.root == fit.id
    assert fit.thread == eager.thread == threading.get_native_id()
    assert fit.start_ns <= eager.start_ns <= eager.end_ns <= fit.end_ns
    assert fit.device_ms is None and eager.device_ms is None  # no card: host only
    # FITC takes no fused core; its Gram calls and its small factor-and-solve
    # pairs are spans of their own
    assert {r.name for r in recs} == {"fit", "fit.eager", "gram.fwd", "gram.bwd", "chol.small"}


def test_fit_optim_and_a_batched_fit_record_their_fits():
    x, y, p = _fitc()
    loss = make_objective("nlml", model="fitc")
    before = profiling._LOG.next_id
    with profile(activities=[ProfilerActivity.CPU]):
        fit_optim(loss, p, x, y, 3, lambda ps: torch.optim.Adam(ps, lr=1e-2))
        g = torch.Generator().manual_seed(1)
        train.fit_gd_batch(loss, init_rand_params(g, 3, 6, batch=2), x, y, 2, 1e-2)
    fits = _by_name(_new(before), "fit")
    assert [(f.attrs["iters"], f.attrs["batch"]) for f in fits] == [(3, None), (2, 2)]
    assert all(f.attrs["objective"] == "nlml_fitc_objective" for f in fits)


def _core_step(core, n=64, block=16):
    g = torch.Generator().manual_seed(n)
    x = torch.randn((n, 3), generator=g)
    y = torch.sin(x.sum(dim=1))
    leaves = [torch.tensor(0.3, requires_grad=True), torch.full((3,), 0.2, requires_grad=True),
              torch.tensor(-1.2, requires_grad=True)]
    if core == "loo":
        a, d = loo_fused.ard_loo_solve_diag(*leaves, x, y, block)
        out = (a * a / d).sum()
    else:
        e, hld, inv_diag, a = fold_stream.ard_fold_stats_stream(*leaves, x, y, 4, True, block)
        out = (e * e).sum() + hld.sum() + inv_diag.sum()
    torch.autograd.grad(out, leaves)


@pytest.mark.parametrize("core,name,passes", [("loo", "loo", 1), ("folds", "fold_stats", 4)])
def test_fused_cores_record_forward_and_backward_under_one_root(core, name, passes):
    before = profiling._LOG.next_id
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("fit", objective="test", iters=1, batch=None, graph=False) as fit:
            _core_step(core)
    recs = _new(before)
    (fwd,), (bwd,) = _by_name(recs, "core.forward"), _by_name(recs, "core.backward")
    assert fwd.attrs == {"core": name, "n": 64, "block": 16}
    assert bwd.attrs == {"core": name, "passes": passes, "cols": "lower"}
    assert fwd.root == bwd.root == fit.id and fwd.parent == fit.id
    assert fwd.end_ns <= bwd.start_ns
    assert fwd.device_ms is None and bwd.device_ms is None


def test_the_bounded_log_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_LOG", profiling._SpanLog(capacity=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(7):
            with profiling.span("fit.eager", steps=i):
                pass
    recs, dropped = profiling.spans()
    assert dropped == 3 and [r.attrs["steps"] for r in recs] == [3, 4, 5, 6]
    assert profiling.spans()[1] == 3 and len(profiling.spans()[0]) == 4  # reading clears nothing


def test_spans_share_the_profilers_host_clock():
    a = torch.randn(192, 192)
    before = profiling._LOG.next_id
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("core.forward", core="test"):
            a @ a
    (rec,) = _new(before)
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert rec.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= rec.end_ns


def test_trace_exports_the_spans_on_the_kernels_timeline(tmp_path):
    a = torch.randn(192, 192)
    with profiling.trace(str(tmp_path), name="fit"):
        with profiling.span("fit", objective="test", iters=1, batch=None, graph=False):
            a @ a
    with open(tmp_path / "fit.json") as f:
        events = json.load(f)["traceEvents"]
    (sp,) = [e for e in events if e.get("cat") == "gpscore_torch.span"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert sp["name"] == "fit" and sp["args"]["objective"] == "test"
    assert sp["tid"] == mm["tid"] and sp["pid"] == mm["pid"]
    assert sp["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"] + 1e-3


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device times come from CUDA events on a card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_capture_records_no_cuda_events(dev):
    a = torch.randn(64, 64, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    before = profiling._LOG.next_id
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.cuda.stream(side):
            (a @ a).sum()  # warm up on the side stream, as a capture wants
            graph.capture_begin()
            try:
                with profiling.span("core.forward", dev, core="test"):
                    b = a @ a
            finally:
                graph.capture_end()
        graph.replay()
        torch.cuda.synchronize()
    (rec,) = _new(before)
    assert rec.device_ms is None
    torch.testing.assert_close(b, a @ a)


def _device_events(prof, t0_ns=0, t1_ns=None):
    """The profiler's CUDA-typed events that start in [t0_ns, t1_ns)."""
    from torch.autograd import DeviceType

    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.start_ns() >= t0_ns
            and (t1_ns is None or e.start_ns() < t1_ns)]


@pytest.mark.cuda
def test_a_graphed_fits_eager_steps_time_the_card_and_its_capture_does_not(dev):
    a = torch.randn(512, 512, device=dev)
    out = torch.empty_like(a)

    def step():
        torch.mm(a, a, out=out)
        out.tanh_()

    train._replay(step, 6, dev, None)  # warm: kernels and the workspace
    before = profiling._LOG.next_id
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train._replay(step, 3 + 40, dev, None)
        torch.cuda.synchronize()
    recs = _new(before)
    (eager,), (capture,) = _by_name(recs, "fit.eager"), _by_name(recs, "fit.capture")
    assert {r.name for r in recs} == {"fit.eager", "fit.capture"}
    assert eager.attrs == {"steps": 3} and capture.device_ms is None
    # Kernels that start before the capture began are the eager steps' own.
    busy = sum(e.duration_ns() for e in _device_events(prof, eager.start_ns, capture.start_ns))
    assert busy > 0 and eager.device_ms * 1e6 >= busy


@pytest.mark.cuda
def test_spans_add_no_device_event_to_a_traced_fit(dev, monkeypatch):
    x, y, p = _fitc(dev, n=128, m=8, d=4)
    loss = make_objective("crps", model="fitc")

    def device_events_of_a_fit():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fit_gd(loss, p, x, y, 24, 1e-2)
            torch.cuda.synchronize()
        return len(_device_events(prof))

    device_events_of_a_fit()  # warm: kernels, the workspace, the profiler
    before = profiling._LOG.next_id
    with_spans = device_events_of_a_fit()
    assert profiling._LOG.next_id > before  # the spans were on
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    before = profiling._LOG.next_id
    without = device_events_of_a_fit()
    assert profiling._LOG.next_id == before  # the spans were off
    assert with_spans == without > 0
