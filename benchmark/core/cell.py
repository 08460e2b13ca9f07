"""Resolve a cell of ``BENCHMARK.json`` to its files.

A cell names a configuration and a traffic mix. The configuration is the
JSON file that ``configs`` gives for it; the mix is
``benchmark/traffic/<traffic>.py``; each per-layer metric is
``benchmark/metrics/<name>.py``. Nothing here knows any one cell: a later
change adds a cell, a mix or a metric by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Mapping

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic: str
    mix: ModuleType
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, ModuleType]


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file whose name may hold dots."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def mix_path(traffic: str) -> Path:
    return HERE / "traffic" / f"{traffic}.py"


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def reports(metric: Mapping, cell: str, e2e_of_cell: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, or without the key every cell (for a per-layer metric, every cell
    that reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def resolve(bench: Mapping, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = load_module(mix_path(w["traffic"]),
                      f"benchmark.traffic.{w['traffic']}")
    e2e = [m for m in bench["end_to_end"] if reports(m, workload, [])]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if reports(m, workload, names)]
    readers = {m["name"]: load_module(metric_path(m["name"]),
                                      f"benchmark.metrics.{m['name']}")
               for m in layer}
    return Cell(workload, int(w["chips"]), w["config"], config,
                w["traffic"], mix, e2e, layer, readers)
