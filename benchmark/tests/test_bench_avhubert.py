"""The AV-HuBERT cell, ``avhubert_large.bulk_av_windows``: its readers
(``mfu.av_bulk``, ``avhubert.encoder_ms.av_bulk``,
``avhubert.visual_ms.av_bulk``, ``avhubert.encoder_mfu.av_bulk``) on a
synthetic view: known spans, counters and results give known values, and
nothing where the program records none (a checkout without the model); the
FLOP count they divide by, against the layer equations; the configuration
file and its entries in ``BENCHMARK.json``; and what the parametrised tests
of every cell do not ask of it: an altered answer, and each part read alone
at int8."""

import io
import json
import math
import time
import types

import pytest
import torch

from benchmark import run
from benchmark.core import avhubert_flops, peaks
from benchmark.core import cell as cells
from benchmark.core.spans import Spans
from benchmark.core.trace import Trace
from lipsync_tpu_torch.utils import profiling
from lipsync_tpu_torch.utils.profiling import SpanRecord

CELL = "avhubert_large.bulk_av_windows"
NAMES = ("mfu.av_bulk", "avhubert.encoder_ms.av_bulk",
         "avhubert.visual_ms.av_bulk", "avhubert.encoder_mfu.av_bulk")
MS = 1_000_000  # ns
CONFIG = json.loads((cells.ROOT / "benchmark/configs/avhubert_large.json")
                    .read_text())


def reader(name):
    return cells.load_module(cells.metric_path(name), f"m.{name}")


def rec(i, name, t0_ms, t1_ms, parent=None, device_ms=None):
    return SpanRecord(i, parent, parent or i, name, int(t0_ms * MS),
                      int(t1_ms * MS),
                      None if device_ms is None else device_ms / 1e3)


def records():
    """Three groups' forwards, the first before the window: each an
    ``engine.forward`` holding one visual and one encoder span."""
    out = []
    for g, at in enumerate((900, 1100, 1500)):
        f = 10 * (g + 1)
        out += [rec(f, "engine.forward", at, at + 100, parent=100,
                    device_ms=90),
                rec(f + 1, "avhubert.visual", at, at + 50, parent=f,
                    device_ms=40 + 10 * g),
                rec(f + 2, "avhubert.encoder", at + 50, at + 100, parent=f,
                    device_ms=20 + 4 * g)]
    return out


def view(device="cuda", window=(1000 * MS, 2000 * MS)):
    tr = Trace(False)
    tr.window = window
    ctx = types.SimpleNamespace(config=CONFIG,
                                device=types.SimpleNamespace(type=device))
    return run.View(ctx, {"windows": 2048, "elapsed": 0.5}, tr)


@pytest.fixture
def kept(monkeypatch):
    state = {"records": records(),
             "counters": {"avhubert.encoder_tokens": 2 * 256 * 32}}
    monkeypatch.setattr(profiling, "records", lambda: list(state["records"]))
    monkeypatch.setattr(profiling, "counters",
                        lambda: dict(state["counters"]))
    return state


def test_readers(kept):
    v = view()
    # The window holds groups 2 and 3: visual 50 and 60 ms, encoder 24 and
    # 28 ms; the median of two is their mean.
    assert reader(NAMES[1]).read(v) == pytest.approx(26.0)
    assert reader(NAMES[2]).read(v) == pytest.approx(55.0)
    per_token = avhubert_flops.encoder_flops_per_token(CONFIG["model"])
    want = 100 * 2 * 256 * 32 * per_token / 0.052 / peaks.peak("bf16")
    assert reader(NAMES[3]).read(v) == pytest.approx(want)
    per_window = avhubert_flops.forward_flops(CONFIG["model"])
    want = 100 * 2048 * per_window / 0.5 / peaks.peak("bf16")
    assert reader(NAMES[0]).read(v) == pytest.approx(want)


@pytest.mark.parametrize("absent", ["no_spans", "no_device", "no_counter",
                                    "old_program", "cpu"])
def test_nothing_to_read_gives_none(kept, monkeypatch, absent):
    """A window without the spans, spans without device times (the CPU),
    no counter, or a program without the recorder: the span readers give
    None; ``mfu.av_bulk`` reads the host clock and is None only off the
    card."""
    v = view()
    if absent == "no_spans":
        kept["records"] = [r for r in kept["records"]
                           if not r.name.startswith("avhubert.")]
    elif absent == "no_device":
        kept["records"] = [r._replace(device_s=None)
                           for r in kept["records"]]
    elif absent == "no_counter":
        kept["counters"] = {}
    elif absent == "old_program":
        monkeypatch.delattr(profiling, "records")
        monkeypatch.delattr(profiling, "counters")
    else:
        kept["records"] = [r._replace(device_s=None)
                           for r in kept["records"]]
        v = view(device="cpu")
    spans_there = absent == "no_counter"
    for name in NAMES[1:3]:
        assert (reader(name).read(v) is not None) == spans_there, name
    assert reader(NAMES[3]).read(v) is None
    assert (reader(NAMES[0]).read(v) is not None) == (absent != "cpu")


def test_flops_are_the_layer_equations():
    """The encoder's count a token: per layer the four D x D projections
    and the two D x FFN maps (2 FLOPs a multiply-add) and attention's two
    T x D products; the positional convolution's D x D/G x K taps over
    T + 1 output steps (the last dropped after it is computed). The whole
    window: about 40 GFLOP, half of it in the visual path."""
    m = CONFIG["model"]
    d, f, t = m["embed_dim"], m["ffn_dim"], \
        m["video_frames"]
    g, k, n = m["conv_pos_groups"], m["conv_pos"], m["encoder_layers"]
    layer = 2 * (4 * d * d + 2 * d * f) + 2 * 2 * t * d
    pos = 2 * d * (d // g) * k * (t + 1) / t
    assert avhubert_flops.encoder_flops_per_token(m) == n * layer + pos
    total = avhubert_flops.forward_flops(m)
    assert 39e9 < total < 42e9
    assert 0.45 < (total - t * (n * layer + pos)) / total < 0.55


TINY_MODEL = {"video_frames": 8, "crop_size": 48, "audio_frames": 32}
TINY = {"pool": 8, "call": 4, "group": 2}
SEED = 2 ** 31 + 11


def cell(tiny=True):
    c = cells.resolve(cells.load_benchmark(), CELL)
    if tiny:
        c.config = dict(c.config, model=dict(c.config["model"], **TINY_MODEL))
    return c


def rehearse(trace=False, faults=()):
    out = io.StringIO()
    run.execute(cell(), SEED, 1.0, trace, torch.device("cpu"),
                time.perf_counter(), faults=faults, scale=TINY, out=out)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_listed_as_one_cell():
    """One configuration, one one-chip cell and the four readers, all in
    the layer "model step"; ``windows_per_s`` is its end-to-end metric."""
    bench = cells.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}["avhubert_large"]
    assert entry["file"] == "benchmark/configs/avhubert_large.json"
    assert entry["source"] == CONFIG["source"]
    assert entry["reduced"] == CONFIG["reduced"] == []
    w = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "avhubert_large", "bulk_av_windows", 1)
    e2e = [m["name"] for m in cells.resolve(bench, CELL).end_to_end]
    assert sorted(e2e) == ["setup_s", "windows_per_s"]
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        assert layer[name]["layer"] == "model step"
        assert layer[name]["moves"] == "windows_per_s"
        assert layer[name]["workloads"] == [CELL]
        assert cells.metric_path(name).is_file()


def test_config_file():
    """The configuration as run: the published widths under the keys the
    model takes, nothing cut, ~325 M parameters by its own reference, and
    a precision for each of its four parts."""
    from benchmark.reference import avhubert as ref

    assert CONFIG["name"] == "avhubert_large" and CONFIG["reduced"] == []
    m = CONFIG["model"]
    assert (m["encoder_layers"], m["embed_dim"], m["ffn_dim"],
            m["heads"]) == (24, 1024, 4096, 16)
    assert (m["conv_pos"], m["conv_pos_groups"]) == (128, 16)
    n = sum(math.prod(s) for s in ref.param_shapes(m).values())
    assert 3.24e8 < n < 3.25e8
    assert set(CONFIG["precision"]) == {"visual_low", "visual_high",
                                        "audio", "tokens"}
    assert CONFIG["limits"]["logit_gap"] > 0
    assert CONFIG["mfu_peak"]["serve"] == "bf16"


def test_readers_listed_for_the_cell_alone():
    bench = cells.load_benchmark()
    for w in (w["name"] for w in bench["workloads"]):
        readers = cells.resolve(bench, w).readers
        for name in NAMES:
            assert (name in readers) == (w == CELL), (w, name)


def test_an_altered_answer_is_not_correct():
    assert rehearse(faults=("altered_answer",))["correct"] is False


def test_the_control_is_not_correct_and_a_part_read_alone():
    """The program's reading is within the limit and the control's (the
    reference one step below the configuration's precision) above it. The
    ``readings --part`` comparison with int8 in the encoder (``tokens``)
    alone, or in the stem and trunk layers 1-2 (``visual_low``) alone,
    reads a gap of its own (which of them the limit catches is read on the
    card, at the cell's own size)."""
    from benchmark.readings import one_part

    c = cell()
    ctx = run.Context(c.config, SEED, 0.5, torch.device("cpu"),
                      Spans(False), scale=TINY)
    state = c.mix.setup(ctx)
    c.mix.window(state, ctx)
    assert all(v <= lim for _, v, lim in c.mix.check(state, ctx))
    assert all(v > lim for _, v, lim in c.mix.control(state, ctx))
    for part in ("tokens", "visual_low"):
        got = c.mix.control(state, ctx, one_part(
            c.config, c.mix.PRECISION, f"{part}:bf16:int8"))
        assert [n for n, _, _ in got] == ["logit_gap"]
        assert all(v == v and v > 0 for _, v, _ in got), part
