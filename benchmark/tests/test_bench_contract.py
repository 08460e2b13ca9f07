"""``BENCHMARK.json`` against the rules its checker holds it to, and each
cell against the files that make it."""

import json
import math
import re
from pathlib import Path

import pytest

from benchmark.core import cell as cells

ROOT = cells.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_keys_exactly():
    assert set(BENCH) == KEYS["top"]
    for part in ("configs", "workloads"):
        for entry in BENCH[part]:
            assert set(entry) == KEYS[part], entry
    for part in ("end_to_end", "per_layer"):
        for entry in BENCH[part]:
            assert set(entry) - {"workloads"} == KEYS[part], entry


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[part]]
        assert len(names) == len(set(names)), part
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_counts_and_bounds():
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    seconds = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert seconds <= 43200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves(workload):
    c = cells.resolve(BENCH, workload)
    assert c.mix.SPANS and callable(c.mix.setup) and callable(c.mix.check)
    assert callable(c.mix.control) and callable(c.mix.end_to_end)
    assert c.mix.PRECISION in c.config
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(c.readers[m["name"]].read)
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in WORKLOADS


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_metric_lists_only_cells_that_report_what_it_moves(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    moved = {x["name"]: x for x in BENCH["end_to_end"]}[m["moves"]]
    assert m["workloads"], "each per-layer metric names its cells"
    for w in m["workloads"]:
        assert w in WORKLOADS
        assert w in moved.get("workloads", WORKLOADS)
    assert cells.metric_path(metric).is_file()


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"engine", "model step", "model step in training",
                      "kernels", "device"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    path = ROOT / entry["file"]
    assert entry["file"].startswith("benchmark/configs/")
    body = json.loads(path.read_text())
    assert body["name"] == config and body["source"] == entry["source"]
    assert body["reduced"] == entry["reduced"] == []
    from benchmark.reference import model as ref

    shapes = ref.param_shapes(body["model"])
    n = sum(math.prod(s) for s in shapes.values())
    assert 15e6 < n < 20e6  # the published model's parameter count
    assert set(body["precision"]) == set(ref.PARTS)
    assert set(body["limits"]) >= {"logit_gap"}
    assert body["mfu_peak"]["serve"] in ("bf16", "int8")


def test_files_are_named_from_names():
    for p in Path(ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
