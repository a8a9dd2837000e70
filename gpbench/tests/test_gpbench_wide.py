"""The wide cell ``exact30k_d90_dss_folds`` (configuration ``exact_n30720_d90``,
driver ``entries/exact_steps_wide.py``) and its two readers of the program's
Gram spans:

- the reference's closed-form length gradient at d = 90 against float64
  autograd through a dense K_hat;
- the wide start leaves K(x, x) spanning a range off its diagonal (the unit
  start at d = 90 leaves it near the identity), so the check compares the
  kernel;
- the d-chunked bound of a step against a hand count at n = 30,720, and the
  launches and spans a step the driver expects;
- the readers on synthetic span logs: a step's value, normalization over
  retaken fits, and None on the parent (no Gram spans), on a dropped span, on
  missing device time and on a short count;
- the cell on the CPU at n = 256: correct, its control further off, and each
  planted fault of ``test_gpbench_faults.py`` not correct; on the card
  (``cuda``-marked) the faults and the control at the cell's own size.
"""

import math

import pytest
import torch

from gpbench import reference, spec
from gpbench.frozen import data as gen
from gpbench.frozen.peaks import H100_FP32_FLOP_PER_S
from gpbench.frozen.wide import wide_params
from gpbench.metrics import _gram_spans
from gpbench.tests import test_gpbench_faults as faults
from gpbench.tests.helpers import run_cell
from gpbench.tests.test_gpbench_spans import Log
from gpscore_torch.utils import profiling

CELL = "exact30k_d90_dss_folds"
READERS = ["dchunk_gram_ms_per_step.exact", "dchunk_gram_roofline.exact"]


# ---- the reference at d = 90 ------------------------------------------------

def _dense_value(rule, p, x, y, fold_k):
    """The objective through a dense K_hat, for autograd."""
    xs = x * torch.exp(-p["log_length"])[None, :]
    K = torch.exp(p["log_signal_sq"]) * torch.exp(-0.5 * reference.sqdist(xs, xs))
    kinv = torch.linalg.inv(K + torch.exp(p["log_noise_sq"]) * torch.eye(x.shape[0],
                                                                         dtype=x.dtype))
    a = kinv @ y
    if rule == "crps":
        dg = torch.diagonal(kinv)
        return torch.mean(reference.crps_sites(y - a / dg, 1.0 / dg, y))
    nb = x.shape[0] // fold_k
    blocks = torch.stack([kinv[f * nb:(f + 1) * nb, f * nb:(f + 1) * nb] for f in range(fold_k)])
    return reference.fold_loss(rule, blocks, reference._folds(a, fold_k),
                               reference._folds(y, fold_k))


@pytest.mark.parametrize("rule", ["dss", "crps"])
def test_the_closed_form_length_gradient_at_d90(rule):
    x, y = gen.large_n_data(96, 90, 7)
    x, y = x.double(), y.double()
    p = {k: v.double() for k, v in wide_params(90).items()}
    p["log_length"] = p["log_length"] + 0.1 * torch.randn(90, dtype=torch.float64,
                                                          generator=torch.Generator().manual_seed(1))
    value, grads = reference.exact_value_grad(rule, p, x, y, fold_k=4, block=40)
    q = {k: v.clone().requires_grad_() for k, v in p.items()}
    dense = _dense_value(rule, q, x, y, 4)
    auto = dict(zip(q, torch.autograd.grad(dense, list(q.values()))))
    torch.testing.assert_close(value, dense.detach(), rtol=1e-10, atol=0)
    for k in q:
        scale = float(auto[k].abs().max())
        assert float((grads[k] - auto[k]).abs().max()) <= 1e-8 * scale, k


# ---- the wide start ----------------------------------------------------------

def _off_diagonal(p, n=512, d=90, seed=11):
    x, _ = gen.large_n_data(n, d, seed)
    xs = x.double() * torch.exp(-p["log_length"].double())[None, :]
    K = torch.exp(p["log_signal_sq"].double()) * torch.exp(-0.5 * reference.sqdist(xs, xs))
    return K[~torch.eye(n, dtype=torch.bool)], float(torch.exp(p["log_signal_sq"]))


def test_the_wide_start_leaves_k_spanning_a_range():
    off, sig = _off_diagonal(wide_params(90))
    lo, hi = float(off.min()), float(off.max())
    assert lo < 0.5 * hi and hi > 0.01 * sig, (lo, hi, sig)  # the smoke's off_diagonal_span
    # From unit lengths the same rows leave K near the identity: every entry off
    # the diagonal under 1% of sig (read: median 5.5e-6, largest 2.5e-3 of it).
    unit, _ = _off_diagonal(gen.unit_params(90))
    assert float(unit.max()) < 0.01 * sig and float(unit.median()) < 1e-4 * sig


def test_the_wide_start_is_the_seeds_copy():
    p = wide_params(90)
    assert p["log_length"].dtype == torch.float32 and p["log_length"].shape == (90,)
    assert float(p["log_length"][0]) == pytest.approx(1.0 + 0.5 * math.log(90 / 8), rel=1e-7)
    assert float(p["log_signal_sq"]) == float(p["log_noise_sq"]) == 1.0


# ---- the driver's counts -----------------------------------------------------

def _run(n=30720, block=2048):
    cell = spec.load_cell(CELL)
    cell.config["n"] = n
    run = spec.load_entry(cell.traffic["entry"]).Run(cell, 1, None)
    run.block = block
    return run


def test_the_dchunk_bound_against_a_hand_count():
    n, b, d, passes = 30720, 2048, 90, 4
    # Every call is bound by its operations: 3d + 3 an element forward, 6d + 6
    # either backward half; row block k of 15 against k * b columns.
    fwd = (3 * d + 3) * n * n
    bwd = passes * 2 * (6 * d + 6) * b * b * sum(range(1, 16))
    want_us = (fwd + bwd) / H100_FP32_FLOP_PER_S * 1e6
    run = _run()
    assert run.dchunk_bound_us() == pytest.approx(want_us, rel=1e-12)
    assert run.dchunk_bound_us() == pytest.approx(36_650, rel=1e-3)  # 3,845 + 4 x 8,201
    assert run.step_launches(2) == {"fwd_dchunk": 2, "bwd_rows": 120, "bwd_cols": 120}
    # the full-row bound that gram_roofline.exact reads stays exact_steps' own
    base = spec.load_entry("exact_steps").Run(spec.load_cell(CELL), 1, None)
    base.block = b
    assert run.step_gram_bound_us() == pytest.approx(base.step_gram_bound_us())


def test_a_narrow_width_keeps_the_unchunked_key():
    run = _run()
    run.cfg["d"] = 8
    assert run.step_launches(1) == {"fwd": 1, "bwd_rows": 60, "bwd_cols": 60}
    assert run.dchunk_bound_us() == 0.0


# ---- the readers on synthetic logs -------------------------------------------

def _data(steps=2, bound_us=36_650.0, per_step=None):
    return {"kind": "exact", "steps": steps, "dchunk_bound_us": bound_us,
            "gram_spans_per_step": per_step or {"gram.fwd": 1, "gram.bwd": 60}}


def _fit(log, iters, fwd_ms=9.0, bwd_ms=2.0, blocks=60, chunked=True, device=True):
    f = log.add("fit", objective="dss_exact_objective", iters=iters, batch=None, graph=False)
    for _ in range(iters):
        log.add("gram.fwd", f, device_ms=fwd_ms if device else None, kernel="fwd_dchunk",
                n=30720, m=30720, d=90, batch=None, chunked=chunked)
        for k in range(blocks):
            log.add("gram.bwd", f, device_ms=bwd_ms, kernel=("bwd_rows", "bwd_cols"),
                    n=2048, m=2048 * (k % 15 + 1), d=90, batch=None, chunked=chunked)
    return f


def _read(monkeypatch, metric, log, data, dropped=0):
    monkeypatch.setattr(profiling, "spans", lambda: log.spans(dropped))
    return spec.load_reader(metric)(data)


def test_the_readers_read_a_step(monkeypatch):
    log = Log()
    _fit(log, 2)
    ms = _read(monkeypatch, READERS[0], log, _data())
    assert ms == pytest.approx(9.0 + 60 * 2.0)
    share = _read(monkeypatch, READERS[1], log, _data())
    assert share == pytest.approx(100.0 * 36_650.0 / (129.0 * 1e3))


def test_the_readers_normalize_over_retaken_fits(monkeypatch):
    log = Log()
    _fit(log, 2, fwd_ms=9.0)
    _fit(log, 2, fwd_ms=11.0)  # a retake: two more traced steps
    assert _read(monkeypatch, READERS[0], log, _data()) == pytest.approx(10.0 + 120.0)
    assert _read(monkeypatch, READERS[1], log, _data()) == \
        pytest.approx(100.0 * 36_650.0 * 4 / (4 * 130.0 * 1e3))


@pytest.mark.parametrize("metric", READERS)
def test_the_readers_read_none_where_they_cannot(monkeypatch, metric):
    sound = Log()
    _fit(sound, 2)
    assert _read(monkeypatch, metric, sound, _data()) > 0
    # the parent: its fits and cores, no Gram span
    parent = Log()
    parent.step(2, 1000.0, 3000.0)
    assert _read(monkeypatch, metric, parent, _data()) is None
    # the log dropped a span
    assert _read(monkeypatch, metric, sound, _data(), dropped=1) is None
    # a chunked span without device time
    no_time = Log()
    _fit(no_time, 2, device=False)
    assert _read(monkeypatch, metric, no_time, _data()) is None
    # a short count: 59 backward spans a step
    short = Log()
    _fit(short, 2, blocks=59)
    assert _read(monkeypatch, metric, short, _data()) is None
    # no chunked span (d = 8), a driver that names no spans, another kind
    narrow = Log()
    _fit(narrow, 2, chunked=False)
    assert _read(monkeypatch, metric, narrow, _data()) is None
    assert _read(monkeypatch, metric, sound, {"kind": "exact", "steps": 2}) is None
    assert _read(monkeypatch, metric, sound, {**_data(), "kind": "fitc"}) is None
    # a program without a span log
    monkeypatch.delattr(profiling, "spans")
    assert spec.load_reader(metric)(_data()) is None


def test_the_gram_span_reduction_without_fits():
    assert _gram_spans.dchunk_device_ms(_data(), ([], 0)) is None


# ---- the cell ----------------------------------------------------------------

def test_the_cell_resolves_with_its_metrics():
    bench = spec.load_benchmark()
    assert len(bench["workloads"]) == 5 and all(w["chips"] == 1 for w in bench["workloads"])
    cell = spec.load_cell(CELL)
    assert cell.config["d"] == 90 and cell.config["init"] == "wide"
    assert cell.traffic["entry"] == "exact_steps_wide" and cell.traffic["rule"] == "dss"
    assert {m["name"] for m in cell.end_to_end} == {"exact_step_s", "exact_peak_gib", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(READERS) <= names
    assert {"core_forward_ms_per_step.exact", "core_backward_ms_per_step.exact",
            "step_mfu.exact", "idle_share.exact"} <= names
    for metric in READERS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == metric]
        assert m["layer"] == "Gram kernels" and m["moves"] == "exact_step_s"
        assert m["workloads"] == [CELL]


def test_the_cell_on_the_cpu_is_correct_and_its_control_further_off():
    rc, sound, _ = run_cell(CELL, seed=2 ** 31 + 77)
    assert rc == 0 and sound["correct"] is True
    _, control, _ = run_cell(CELL, seed=2 ** 31 + 77, mode="fast")
    assert any(control["checks"][k][0] > sound["checks"][k][0] for k in sound["checks"])


@pytest.mark.parametrize("fault", faults.FAULTS, ids=faults.IDS)
def test_a_broken_timed_path_is_not_correct_in_the_wide_cell(fault, monkeypatch):
    fault(monkeypatch)
    rc, line, _ = run_cell(CELL)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [f for f in faults.FAULTS if f is not faults._state_unchanged],
                         ids=[i for i in faults.IDS if i != "state_unchanged"])
def test_a_broken_timed_path_is_not_correct_in_the_wide_cell_on_the_card(card, fault,
                                                                         monkeypatch, capsys):
    """The faults at the cell's own size, on three seeds; the readings go to
    standard output for the limits' upper ends."""
    import json

    from gpbench import run

    fault(monkeypatch)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        assert run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "1"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with capsys.disabled():
            print(f"[fault] {CELL} {fault.__name__} {seed} {json.dumps(line['checks'])}")
        assert line["correct"] is False
