"""One run's result line has exactly the contract's keys, and a run without
a card prints nothing and exits non-zero."""

import contextlib
import io

import pytest
import torch

from gpbench.tests.helpers import run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("workload", ["fitc20_fit", "fitc20_restarts64", "exact30k_crps_loo",
                                      "exact30k_dss_folds"])
def test_last_line_keys(workload):
    rc, line, _ = run_cell(workload)
    assert rc == 0
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert m["value"] > 0 or name == "exact_peak_gib"  # no allocator peak on the CPU
    for value, limit in line["checks"].values():
        assert value <= limit


def test_no_card_no_result(monkeypatch):
    from gpbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", "fitc20_fit", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and gpbench/, the run fails
    (on the CPU, past the look for a card)."""
    import shutil
    import subprocess
    import sys

    from gpbench import spec

    shutil.copytree(spec.BENCH_DIR, tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; from gpbench import run; sys.exit(run.main(['--workload', "
            "'fitc20_fit', '--seed', '1', '--seconds', '1'], device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_large_seed_gives_the_same_inputs():
    from gpbench.frozen import data as gen

    seed = 2 ** 31 + 12345
    a = gen.synthesize_kin40k_like(seed)[0]
    b = gen.synthesize_kin40k_like(seed)[0]
    assert (a == b).all()
    assert torch.equal(gen.large_n_data(32, 8, seed)[0], gen.large_n_data(32, 8, seed)[0])
