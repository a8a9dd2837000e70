"""The readers of the program's spans on synthetic span logs: per-rule
means summed over the rules, normalization over retaken traced calls, and None where the log
dropped a span, a span lacks device time, no fit span is there, or the
program keeps no span log."""

import pytest

from gpbench import spec
from gpbench.metrics import _spans
from gpscore_torch.utils import profiling
from gpscore_torch.utils.profiling import Span


class Log:
    """A span log built by hand: each fit's spans as its children."""

    def __init__(self):
        self.recs = []

    def add(self, name, root=None, ms=1.0, device_ms=None, **attrs):
        sid = len(self.recs)
        start = 1_000_000 * sid
        self.recs.append(Span(sid, root, sid if name == "fit" else root, name, attrs, 7, start,
                              start + int(ms * 1e6), device_ms))
        return sid

    def fit(self, objective, iters, eager_ms=0.0, capture_ms=0.0):
        """A graphed FITC fit."""
        f = self.add("fit", objective=objective, iters=iters, batch=None, graph=True)
        self.add("fit.eager", f, eager_ms, device_ms=eager_ms, steps=3)
        self.add("fit.capture", f, capture_ms)
        return f

    def step(self, iters, fwd_ms, bwd_ms):
        """An eager large-n fit of ``iters`` steps."""
        f = self.add("fit", objective="crps_exact_objective", iters=iters, batch=None,
                     graph=False)
        self.add("fit.eager", f, device_ms=fwd_ms + bwd_ms, steps=iters)
        for _ in range(iters):
            self.add("core.forward", f, device_ms=fwd_ms / iters, core="loo", n=64, block=16)
            self.add("core.backward", f, device_ms=bwd_ms / iters, core="loo", passes=1)

    def spans(self, dropped=0):
        return self.recs, dropped


FITC = {"kind": "fitc", "rules": {"crps": {"iters": 2000}, "nlml": {"iters": 3000}}}
EXACT = {"kind": "exact"}


def test_host_ms_per_fit_is_the_mean_over_a_rules_fits_summed_over_rules():
    log = Log()
    # crps traced twice and retaken once: three fits, the mean is 30 ms.
    for ms in (20.0, 30.0, 40.0):
        log.fit("crps_fitc_objective", 23, eager_ms=ms, capture_ms=ms / 10)
    log.fit("nlml_fitc_objective", 223, eager_ms=50.0, capture_ms=5.0)
    assert _spans.fitc_host_ms_per_fit(FITC, log.spans(), "fit.eager") == pytest.approx(80.0)
    assert _spans.fitc_host_ms_per_fit(FITC, log.spans(), "fit.capture") == pytest.approx(8.0)


def test_core_ms_per_step_normalizes_over_the_retaken_fits():
    log = Log()
    log.step(2, 1000.0, 3000.0)
    log.step(2, 1000.0, 3000.0)  # a retake: two more steps
    assert _spans.exact_device_ms_per_step(EXACT, log.spans(), "core.forward") == \
        pytest.approx(500.0)
    assert _spans.exact_device_ms_per_step(EXACT, log.spans(), "core.backward") == \
        pytest.approx(1500.0)


def test_none_where_the_log_dropped_or_a_span_lacks_device_time():
    log = Log()
    log.fit("crps_fitc_objective", 23, eager_ms=10.0)
    log.fit("nlml_fitc_objective", 23, eager_ms=10.0)
    assert _spans.fitc_host_ms_per_fit(FITC, log.spans(), "fit.eager") == pytest.approx(20.0)
    assert _spans.fitc_host_ms_per_fit(FITC, log.spans(dropped=1), "fit.eager") is None
    exact = Log()
    exact.step(2, 1000.0, 3000.0)
    assert _spans.exact_device_ms_per_step(EXACT, exact.spans(1), "core.forward") is None
    exact.add("core.backward", 0, core="loo", passes=1)  # no device time
    assert _spans.exact_device_ms_per_step(EXACT, exact.spans(), "core.backward") is None
    assert _spans.exact_device_ms_per_step(EXACT, exact.spans(), "core.forward") == \
        pytest.approx(500.0)


def test_none_without_fit_spans_or_outside_their_kind():
    log = Log()
    log.fit("crps_fitc_objective", 23, eager_ms=10.0)
    assert _spans.fitc_host_ms_per_fit(FITC, log.spans(), "fit.eager") is None  # no nlml fit
    assert _spans.exact_device_ms_per_step(EXACT, ([], 0), "core.forward") is None
    assert _spans.exact_device_ms_per_step(FITC, log.spans(), "core.forward") is None
    assert _spans.fitc_host_ms_per_fit(EXACT, log.spans(), "fit.eager") is None


@pytest.mark.parametrize("metric", ["eager_ms_per_fit.fitc", "capture_ms_per_fit.fitc",
                                    "core_forward_ms_per_step.exact",
                                    "core_backward_ms_per_step.exact"])
def test_readers_read_the_programs_log_and_none_without_one(monkeypatch, metric):
    fitc, exact = Log(), Log()
    for rule in FITC["rules"]:
        fitc.fit(f"{rule}_fitc_objective", 23, eager_ms=12.0, capture_ms=3.0)
    exact.step(2, 1000.0, 3000.0)
    data, log = (FITC, fitc) if metric.endswith(".fitc") else (EXACT, exact)
    monkeypatch.setattr(profiling, "spans", log.spans)
    assert spec.load_reader(metric)(data) > 0
    monkeypatch.delattr(profiling, "spans")  # a program without a span log
    assert spec.load_reader(metric)(data) is None
