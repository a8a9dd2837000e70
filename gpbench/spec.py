"""The benchmark's data, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives for its name; the
traffic mix is ``gpbench/workloads/<traffic>.json``; its ``entry`` names the
driver ``gpbench/entries/<entry>.py``; a per-layer metric ``<name>`` is read
by ``gpbench/metrics/<name>.py``. Adding a cell, a configuration, a traffic
mix or a metric is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: list  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list  # its per-layer metrics


def load_benchmark(root=None) -> dict:
    path = Path(root or ROOT) / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def _one(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named {name!r}")
    return found[0]


def _reports(metric, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root=None, bench_dir=None) -> Cell:
    root = Path(root or ROOT)
    bench_dir = Path(bench_dir or BENCH_DIR)
    bench = load_benchmark(root)
    w = _one(bench["workloads"], name, "workloads")
    cfg = _one(bench["configs"], w["config"], "configs")
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "workloads" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    if traffic.get("config", w["config"]) != w["config"]:
        raise ValueError(f"traffic {w['traffic']!r} is for configuration {traffic['config']!r}, "
                         f"the cell names {w['config']!r}")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def _load_module(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(entry: str, bench_dir=None):
    """The driver module ``entries/<entry>.py``."""
    return _load_module(Path(bench_dir or BENCH_DIR) / "entries" / f"{entry}.py",
                        f"gpbench.entries.{entry}")


def load_reader(metric: str, bench_dir=None):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``'s ``read``."""
    mod = _load_module(Path(bench_dir or BENCH_DIR) / "metrics" / f"{metric}.py",
                       "gpbench.metrics." + metric.replace(".", "_"))
    return mod.read
