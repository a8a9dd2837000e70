"""Nothing a cell runs loads JAX or the JAX package, and the reference loads
nothing of the program. Each check runs in a fresh process, so that what
the test process itself imported does not count."""

import json
import subprocess
import sys

from gpbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "gpscore"}


def _modules_after(code: str) -> set:
    script = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", script], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                       "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cell_run_loads_no_jax():
    loaded = _modules_after(
        "import torch\ntorch.set_num_threads(1)\n"
        "from gpbench.tests.helpers import run_cell\n"
        "for w in ('fitc20_fit', 'exact30k_dss_folds'):\n"
        "    rc, line, _ = run_cell(w)\n"
        "    assert rc == 0 and line['correct'], (w, rc, line)\n")
    assert "gpscore_torch" in loaded  # the program ran
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import gpbench.reference, gpbench.frozen.data, "
                            "gpbench.frozen.gram_roofline, gpbench.frozen.step_flop, "
                            "gpbench.frozen.fitc_flop, gpbench.frozen.kernel_kind")
    assert "gpscore_torch" not in loaded and not loaded & FORBIDDEN


def test_the_forbidden_names_are_compared_whole():
    from gpbench.run import forbidden_modules

    before = set(sys.modules)
    sys.modules.setdefault("gpscore_torch_like_probe", sys)
    try:
        assert "gpscore" not in forbidden_modules() or "gpscore" in {m.split(".")[0] for m in before}
    finally:
        sys.modules.pop("gpscore_torch_like_probe", None)
