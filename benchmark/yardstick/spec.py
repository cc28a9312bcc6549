"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix and the readers of its metrics, each found by name.

  configuration  the "file" of its entry in "configs"
  traffic mix    traffic/<traffic>.json
  metric         metrics/<name>.py, a module with read(run) -> float | None

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = BENCH_DIR.parent  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, as it is run
    mix: dict  # the traffic mix's file
    end_to_end: list[dict]  # the entries of the metrics this cell reports
    per_layer: list[dict]
    root: Path = ROOT  # the checkout whose files these are


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / BENCH_DIR.name / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)], root=root,
    )


def reader(metric: str, root: Path = ROOT):
    """The read function of metrics/<metric>.py."""
    path = root / BENCH_DIR.name / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location("bench_metric_" + metric.replace(".", "_"), path)
    if mod_spec is None or mod_spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
