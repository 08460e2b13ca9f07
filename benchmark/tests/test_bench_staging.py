"""The readers of the engine's pinned staging:
``engine.upload_staged_share.bulk`` (the program's staged bytes over its
uploaded bytes, and nothing where the program counts no staged bytes, a
checkout without the pinned ring, or no uploads) and
``engine.upload_whole_gbps.bulk`` (the bytes over each upload's staging on
the host plus its copy on the device, and the copy alone where nothing is
staged)."""

import types

import pytest

from benchmark import run
from benchmark.core import cell as cells
from benchmark.core.trace import Trace
from lipsync_tpu_torch.utils import profiling
from lipsync_tpu_torch.utils.profiling import SpanRecord

NAME = "engine.upload_staged_share.bulk"
WHOLE = "engine.upload_whole_gbps.bulk"
MS = 1_000_000  # ns


def reader(name=NAME):
    return cells.load_module(cells.metric_path(name), f"m.{name}")


@pytest.mark.parametrize("counters,want", [
    ({"engine.upload_bytes": 800, "engine.upload_staged_bytes": 800}, 100.0),
    ({"engine.upload_bytes": 800, "engine.upload_staged_bytes": 200}, 25.0),
    ({"engine.upload_bytes": 800}, None),
    ({}, None),
])
def test_staged_share(monkeypatch, counters, want):
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    got = reader().read(types.SimpleNamespace())
    assert got == (None if want is None else pytest.approx(want))


def rec(i, name, t0_ms, t1_ms, parent=None, device_ms=None):
    return SpanRecord(i, parent, i if parent is None else parent, name,
                      int(t0_ms * MS), int(t1_ms * MS),
                      None if device_ms is None else device_ms / 1e3)


@pytest.mark.parametrize("staged,want", [
    # 0.6 GB over 10 + 20 ms of staging and 5 + 5 ms of copying.
    (True, 0.6 / 0.040),
    # Nothing staged: the copies' 10 ms alone, as engine.upload_gbps.bulk.
    (False, 0.6 / 0.010),
])
def test_whole_upload_rate(monkeypatch, staged, want):
    records = [rec(1, "engine.upload", 900, 950, device_ms=50),  # before
               rec(2, "engine.upload", 1100, 1130, device_ms=5),
               rec(3, "engine.upload", 1500, 1530, device_ms=5)]
    if staged:
        records += [rec(4, "engine.stage", 1100, 1110, parent=2),
                    rec(5, "engine.stage", 1500, 1520, parent=3),
                    rec(6, "engine.stage", 920, 940, parent=1)]
    monkeypatch.setattr(profiling, "records", lambda: list(records))
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"engine.upload_bytes": 600_000_000})
    tr = Trace(False)
    tr.window = (1000 * MS, 2000 * MS)
    view = run.View(types.SimpleNamespace(), {"elapsed": 1.0}, tr)
    assert reader(WHOLE).read(view) == pytest.approx(want)
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert reader(WHOLE).read(view) is None


@pytest.mark.parametrize("name", [NAME, WHOLE])
def test_listed_for_both_bulk_cells(name):
    bench = cells.load_benchmark()
    for cell in ("flagship.bulk_windows", "flagship_int8.bulk_windows"):
        assert name in cells.resolve(bench, cell).readers
    assert name not in cells.resolve(bench, "flagship.train_b32").readers
