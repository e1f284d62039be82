"""What a cell is made of, found by name from ``BENCHMARK.json``: the
configuration file, the family module that builds and serves it
(``families/<family>.py``), the traffic file (``traffic/<traffic>.json``),
the correctness limits (``limits/<workload>.json``) and one reader a metric
(``metrics/<metric>.py``). Adding any of them takes new files only."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(root: str, workload: str) -> Cell:
    """The cell named ``workload`` of ``<root>/BENCHMARK.json``."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(workload=w, config=_read_json(os.path.join(root, conf["file"])),
                traffic=_read_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
                limits=_read_json(os.path.join(BENCH_DIR, "limits", workload + ".json")),
                end_to_end=e2e, per_layer=per_layer)


def family(cell: Cell) -> ModuleType:
    """The module that builds, serves and checks the cell's configuration."""
    fam = cell.config["family"]
    return load_module(os.path.join(BENCH_DIR, "families", fam + ".py"), f"benchmark_family_{fam}")


def readers(metrics: List[dict]) -> Dict[str, ModuleType]:
    """Metric name -> its reader module (``read(record) -> float | None``)."""
    return {m["name"]: load_module(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"),
                                   "benchmark_metric_" + m["name"].replace(".", "_").replace("-", "_"))
            for m in metrics}
