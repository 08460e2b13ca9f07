"""The readers of the program's own spans and counters
(``benchmark/core/program.py`` and the metrics that use it): known spans,
counters and busy intervals on a synthetic view give known values, and
nothing where the records are absent; on the card, the program's spans
against the benchmark's and the device trace."""

import io
import json
import time
import types

import pytest

from benchmark import run
from benchmark.core import cell as cells
from benchmark.core import program
from benchmark.core.trace import Trace
from lipsync_tpu_torch.utils import profiling
from lipsync_tpu_torch.utils.profiling import SpanRecord

BENCH = cells.load_benchmark()
MS = 1_000_000  # ns
NEW = {
    "flagship.bulk_windows": ("engine.upload_share.bulk",
                              "engine.upload_gbps.bulk",
                              "engine.forward_ms.bulk"),
    "flagship.train_b32": ("train.forward_ms.train",
                           "train.backward_ms.train",
                           "train.update_ms.train",
                           "train.step_idle_share.train"),
}


def reader(name):
    return cells.load_module(cells.metric_path(name), f"m.{name}")


def view(window=(1000 * MS, 2000 * MS), busy=(), elapsed=1.0):
    tr = Trace(False)
    tr.window = window
    tr.kernels = [(s, t, "k") for s, t in busy]
    return run.View(types.SimpleNamespace(), {"elapsed": elapsed}, tr)


def rec(i, name, t0_ms, t1_ms, parent=None, root=None, device_ms=None):
    return SpanRecord(i, parent, root or i, name, int(t0_ms * MS),
                      int(t1_ms * MS),
                      None if device_ms is None else device_ms / 1e3)


@pytest.fixture
def kept(monkeypatch):
    """Set the program's records and counters a reader sees."""
    state = {"records": [], "counters": {}}
    monkeypatch.setattr(profiling, "records", lambda: list(state["records"]))
    monkeypatch.setattr(profiling, "counters",
                        lambda: dict(state["counters"]))
    return state


def engine_records():
    """Two groups inside the window, one before it."""
    out = [rec(1, "engine.upload", 900, 950, parent=9, device_ms=50)]
    for g, at in enumerate((1100, 1500)):
        d = 10 + 10 * g
        out += [rec(d, "engine.dispatch", at, at + 300, parent=100),
                rec(d + 1, "engine.pad", at, at + 20, parent=d),
                rec(d + 2, "engine.upload", at + 20, at + 120, parent=d,
                    device_ms=40 + 20 * g),
                rec(d + 3, "engine.forward", at + 120, at + 300, parent=d,
                    device_ms=200 + 100 * g)]
    return out


def test_engine_readers(kept):
    kept["records"] = engine_records()
    kept["counters"] = {"engine.upload_bytes": 600_000_000}
    v = view(elapsed=2.0)
    # Host: two uploads of 100 ms in a 2 s window.
    assert reader("engine.upload_share.bulk").read(v) == pytest.approx(10.0)
    # 0.6 GB over 40 + 60 ms of device time.
    assert reader("engine.upload_gbps.bulk").read(v) == pytest.approx(6.0)
    # Groups' forwards 200 and 300 ms.
    assert reader("engine.forward_ms.bulk").read(v) == pytest.approx(250.0)


def train_records():
    out = []
    for s, at in enumerate((1100, 1400, 1700)):
        root = 100 + 10 * s
        out.append(rec(root, "train.step", at, at + 250))
        for k, (name, ms) in enumerate((("train.augment", 5),
                                        ("train.forward", 80 + s),
                                        ("train.backward", 150 + 2 * s),
                                        ("train.update", 4))):
            out.append(rec(root + k + 1, name, at + 50 * k, at + 50 * k + 40,
                           parent=root, root=root, device_ms=ms))
    return out


def test_train_readers(kept):
    kept["records"] = train_records()
    # Busy from 1000 to 1150 and 1200 to 2000 ms: the card idles 50 ms,
    # all of it inside the first step.
    v = view(busy=[(1000 * MS, 1150 * MS), (1200 * MS, 2000 * MS)])
    assert reader("train.forward_ms.train").read(v) == pytest.approx(81.0)
    assert reader("train.backward_ms.train").read(v) == pytest.approx(152.0)
    assert reader("train.update_ms.train").read(v) == pytest.approx(4.0)
    assert reader("train.step_idle_share.train").read(v) == pytest.approx(
        5.0)
    # Idle outside every step does not count.
    v = view(busy=[(1000 * MS, 1050 * MS), (1100 * MS, 2000 * MS)])
    assert reader("train.step_idle_share.train").read(v) == 0.0


def test_idle_inside_sums_every_overlap():
    v = view(busy=[(1100 * MS, 1200 * MS), (1300 * MS, 1400 * MS)])
    spans = [rec(1, "s", 1050, 1150), rec(2, "s", 1180, 1350),
             rec(3, "s", 1390, 1500)]
    # Idle 1000-1100, 1200-1300, 1400-2000; inside: 50 + 100 + 100 ms.
    assert program.idle_inside(v, spans) == pytest.approx(0.25)


@pytest.mark.parametrize("absent", ["no_spans", "no_device", "no_window",
                                    "old_program"])
def test_nothing_to_read_gives_none(kept, monkeypatch, absent):
    """No spans in the window, records without device times (the CPU), no
    window, or a program without the recorder: every new reader gives
    None, except the host share where its spans exist."""
    kept["records"] = engine_records() + train_records()
    kept["counters"] = {"engine.upload_bytes": 1}
    v = view(busy=[(1000 * MS, 1010 * MS)])
    host = set()
    if absent == "no_spans":
        v = view(window=(5000 * MS, 6000 * MS),
                 busy=[(5000 * MS, 5001 * MS)])
    elif absent == "no_device":
        kept["records"] = [r._replace(device_s=None)
                           for r in kept["records"]]
        v = view()  # and no kernel in the trace
        host = {"engine.upload_share.bulk"}
    elif absent == "no_window":
        v = view(window=None)
    else:
        monkeypatch.delattr(profiling, "records")
    for names in NEW.values():
        for name in names:
            got = reader(name).read(v)
            assert (got is not None) == (name in host), (name, got)


def test_every_new_metric_has_a_reader_and_an_entry():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            assert cells.metric_path(name).is_file()
            assert cell in entries[name]["workloads"]
    for name in NEW["flagship.bulk_windows"]:
        assert "flagship_int8.bulk_windows" in entries[name]["workloads"]


# ── on the card ───────────────────────────────────────────────────────────


def traced_view(monkeypatch, card, workload, seconds=4.0):
    """A short traced run of ``workload`` through ``run.execute``, and the
    view its readers were given."""
    views = []

    class Keep(run.View):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            views.append(self)

    monkeypatch.setattr(run, "View", Keep)
    profiling.clear()
    out = io.StringIO()
    run.execute(cells.resolve(BENCH, workload), 2 ** 33 + 5, seconds, True,
                card, time.perf_counter(), out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    return views[0], line


def outside_ms(inner, outer):
    """The most that any program span in ``inner`` pokes out of the
    benchmark span in ``outer`` that holds it best, in ms (0: inside)."""
    worst = 0.0
    for r in inner:
        best = min((max(0, s - r.t0_ns) + max(0, r.t1_ns - t)
                    for s, t, _ in outer), default=float("inf"))
        worst = max(worst, best / 1e6)
    return worst


@pytest.mark.card
@pytest.mark.parametrize("workload", ["flagship.bulk_windows",
                                      "flagship_int8.bulk_windows"])
def test_engine_spans_agree_with_the_trace(card, monkeypatch, workload):
    """Every ``engine.dispatch`` lies inside a benchmark
    ``dispatch_logits`` span within 0.2 ms, on the trace's clock; the
    uploads' device seconds are within 15% of the trace's host-to-device
    copies; the line reports every new engine metric."""
    v, line = traced_view(monkeypatch, card, workload)
    dispatch = program.spans(v, "engine.dispatch")
    outer = [x for x in v.trace.spans if x[2] == "dispatch_logits"]
    assert dispatch and outside_ms(dispatch, outer) <= 0.2
    uploads = program.device_s(program.spans(v, "engine.upload"))
    copies, _ = v.trace.kernel_seconds(("Memcpy HtoD",))
    assert abs(uploads - copies) <= 0.15 * copies, (uploads, copies)
    assert set(NEW["flagship.bulk_windows"]) <= set(line["metrics"])


@pytest.mark.card
def test_train_spans_agree_with_the_trace(card, monkeypatch):
    """Every ``train.step`` lies inside a benchmark ``train_step`` span
    within 0.2 ms; the four children's device seconds over the window's
    steps are within 10% of the trace's busy seconds."""
    v, line = traced_view(monkeypatch, card, "flagship.train_b32")
    steps = program.spans(v, "train.step")
    outer = [x for x in v.trace.spans if x[2] == "train_step"]
    assert steps and outside_ms(steps, outer) <= 0.2
    ids = {r.id for r in steps}
    kids = [r for r in profiling.records() if r.parent in ids]
    assert len(kids) == 4 * len(steps)
    busy = v.trace.busy_s()
    assert abs(program.device_s(kids) - busy) <= 0.1 * busy
    assert set(NEW["flagship.train_b32"]) <= set(line["metrics"])
