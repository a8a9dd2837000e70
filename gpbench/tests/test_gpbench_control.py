"""The control: a lower precision put in the timed path, which the check must
fail. It is the program's own lower-precision path ("fast", one TF32 pass in
place of IEEE fp32 for its non-critical products) unless the traffic mix's
``check.control`` names another: ``tf32``, TF32 beneath the program for
every fp32 cuBLAS product (where "fast" reads within fp32's own rounding).

On the CPU the modes are the program's emulations, at a tiny size: "fast"
reads further from float64 than the sound run. On the card (``cuda``-marked;
``python -m pytest -m cuda gpbench/tests``) each cell runs at its own size on
three seeds with its control and must come out not correct, and once as it
is, correct."""

import json
import subprocess
import sys

import pytest

from gpbench import spec
from gpbench.tests.helpers import run_cell

CELLS = ["fitc20_fit", "fitc20_restarts64", "exact30k_crps_loo", "exact30k_dss_folds"]


@pytest.mark.parametrize("workload", ["fitc20_fit", "exact30k_dss_folds"])
def test_the_control_reads_further_off_on_the_cpu(workload):
    _, sound, _ = run_cell(workload, seed=31)
    _, control, _ = run_cell(workload, seed=31, mode="fast")
    assert set(sound["checks"]) == set(control["checks"])
    assert any(control["checks"][k][0] > sound["checks"][k][0] for k in sound["checks"])


def _run(workload, seed, mode=None, seconds=3):
    cmd = [sys.executable, "-m", "gpbench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", "0"] + (["--mode", mode] if mode else [])
    out = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_card(card, workload):
    control = spec.load_cell(workload).traffic["check"].get("control", "fast")
    assert _run(workload, 2 ** 31 + 17)["correct"] is True
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        assert _run(workload, seed, mode=control)["correct"] is False
