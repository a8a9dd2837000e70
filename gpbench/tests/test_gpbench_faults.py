"""The check fails a run whose timed path is broken underneath: each fault is
planted in the program, the harness runs the rest of a run as it is (on the
CPU, at a tiny size, past the look for a card), and ``correct`` comes out
false. The cells run on one chip, so no exchange between chips can be left
out."""

import pytest

from gpbench.tests.helpers import run_cell

CELLS = ["fitc20_fit", "fitc20_restarts64", "exact30k_crps_loo", "exact30k_dss_folds"]


def _state_unchanged(monkeypatch):
    """Every step returns its state unchanged: the update applies nothing."""
    from gpscore_torch.fit import train

    real = train._gd

    def frozen(loss_fn, params, x, y, iters, lr, lr_inducing, *rest):
        return real(loss_fn, params, x, y, iters, 0.0, 0.0, *rest)

    monkeypatch.setattr(train, "_gd", frozen)


def _inducing_frozen(monkeypatch):
    """The inducing points left where they start: their rate set to nought,
    every other leaf's update as it is."""
    from gpscore_torch.fit import train

    real = train._gd

    def frozen(loss_fn, params, x, y, iters, lr, lr_inducing, *rest):
        return real(loss_fn, params, x, y, iters, lr, 0.0, *rest)

    monkeypatch.setattr(train, "_gd", frozen)


def _rates_swapped(monkeypatch):
    """The inducing points stepped at the other leaves' rate and the other
    leaves at the inducing points' (nlml's rates differ tenfold)."""
    from gpscore_torch.fit import train

    real = train._gd

    def swapped(loss_fn, params, x, y, iters, lr, lr_inducing, *rest):
        return real(loss_fn, params, x, y, iters, lr if lr_inducing is None else lr_inducing,
                    lr, *rest)

    monkeypatch.setattr(train, "_gd", swapped)


def _wrap_objective(monkeypatch, wrap):
    import gpscore_torch.fit as fit

    real = fit.make_objective

    def make(*a, **kw):
        return wrap(real(*a, **kw))

    monkeypatch.setattr(fit, "make_objective", make)


def _half_batch(monkeypatch):
    """Half of the rows left out, the mean (or sum) taken over the rest (a
    multiple of 8 rows, so that the folds still divide them)."""
    def wrap(loss):
        def half(params, x, y, *a, **kw):
            n = x.shape[-2] // 2 // 8 * 8
            return loss(params, x[..., :n, :], y[..., :n], *a, **kw)
        return half
    _wrap_objective(monkeypatch, wrap)


def _answer_altered(monkeypatch):
    """The loss altered where it is produced, by one part in a thousand."""
    def wrap(loss):
        def altered(*a, **kw):
            return loss(*a, **kw) * (1.0 + 1e-3)
        return altered
    _wrap_objective(monkeypatch, wrap)


FAULTS = [_state_unchanged, _half_batch, _answer_altered]
IDS = ["state_unchanged", "half_batch", "answer_altered"]
FITC = ["fitc20_fit", "fitc20_restarts64"]
# the inducing points' own rate exists only in the FITC cells
CASES = [(w, f) for w in CELLS for f in FAULTS] + \
    [(w, f) for w in FITC for f in (_inducing_frozen, _rates_swapped)]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{f.__name__.strip('_')}-{w}" for w, f in CASES])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    rc, sound, _ = run_cell(workload)
    assert rc == 0 and sound["correct"] is True
    fault(monkeypatch)
    rc, line, _ = run_cell(workload)
    assert rc == 0 and line["correct"] is False, line["checks"]


# At the cells' own size; a state left unchanged reads 1 by the exact cells'
# gradient numbers and needs no run there.
CARD = [(w, f) for w, f in CASES if not (w.startswith("exact") and f is _state_unchanged)]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", CARD,
                         ids=[f"{f.__name__.strip('_')}-{w}" for w, f in CARD])
def test_a_broken_timed_path_is_not_correct_on_the_card(card, workload, fault, monkeypatch,
                                                        capsys):
    """The same faults at the cell's own size, on three seeds; the readings go
    to standard output for the limits' upper ends."""
    import json

    from gpbench import run

    fault(monkeypatch)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        assert run.main(["--workload", workload, "--seed", str(seed), "--seconds", "1"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with capsys.disabled():
            print(f"[fault] {workload} {fault.__name__} {seed} {json.dumps(line['checks'])}")
        assert line["correct"] is False
