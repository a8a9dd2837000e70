"""The harness is data: a configuration, a traffic mix and a per-layer metric
added as new files are found by name, without editing any file already there."""

import json
import shutil

from gpbench import spec

REPO = spec.ROOT


def _copy(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(REPO / "gpbench", root / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_every_cell_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.traffic["config"] == w["config"]
        assert spec.load_entry(cell.traffic["entry"]).Run
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.load_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_new_config_traffic_and_metric_as_files(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "gpbench").rglob("*") if p.is_file()}
    cfg = json.loads((root / "gpbench/configs/kin40k_fitc20.json").read_text())
    cfg["name"] = "kin40k_fitc64"
    cfg["num_inducing"] = 64
    (root / "gpbench/configs/kin40k_fitc64.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "gpbench/workloads/fitc20_fit.json").read_text())
    traffic.update(config="kin40k_fitc64", rules=["crps"])
    (root / "gpbench/workloads/fitc64_crps.json").write_text(json.dumps(traffic))
    (root / "gpbench/metrics/capture_ms.fitc.py").write_text("def read(data):\n    return 1.5\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "kin40k_fitc64", "source": "x",
                             "file": "gpbench/configs/kin40k_fitc64.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "fitc64_crps", "config": "kin40k_fitc64",
                               "traffic": "fitc64_crps", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "capture_ms.fitc", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "GD loop",
                               "moves": "fitc_fit_s", "workloads": ["fitc64_crps"]})
    for m in bench["end_to_end"]:
        if m["name"] == "fitc_fit_s":
            m["workloads"].append("fitc64_crps")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("fitc64_crps", root=root, bench_dir=root / "gpbench")
    assert cell.config["num_inducing"] == 64 and cell.traffic["rules"] == ["crps"]
    assert [m["name"] for m in cell.per_layer] == ["capture_ms.fitc"]
    assert {m["name"] for m in cell.end_to_end} == {"fitc_fit_s", "setup_s"}
    assert spec.load_reader("capture_ms.fitc", bench_dir=root / "gpbench")({}) == 1.5
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed


def test_a_metric_without_workloads_follows_its_moves(tmp_path):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "x.exact", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "exact_step_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    names = {m["name"] for m in spec.load_cell("exact30k_dss_folds", root=root).per_layer}
    assert "x.exact" in names
    assert "x.exact" not in {m["name"] for m in spec.load_cell("fitc20_fit", root=root).per_layer}
