"""The Auto-AVSR cell, ``auto_avsr.bulk_av_pcm_windows``: its readers
(``mfu.avsr_bulk``, ``auto_avsr.video_ms.avsr_bulk``,
``auto_avsr.audio_ms.avsr_bulk``, ``auto_avsr.conformer_ms.avsr_bulk``,
``auto_avsr.conformer_mfu.avsr_bulk``, ``k5_swish_stem_roofline``) on a
synthetic view: known spans, counters and results give known values, and
nothing where the program records none (a checkout without the model); the
FLOP count they divide by, against the layer equations; the configuration
file, counted with the reference's table and the model's parts, and its
entries in ``BENCHMARK.json``; and a rehearsal of the mix at a small
size: the program's reading within the limit, an altered answer; at the
published widths, the control above the limit and each part read alone
one step lower above zero (which parts the limit catches is read on the
card, at the cell's own size)."""

import io
import json
import math
import time
import types

import pytest
import torch

from benchmark import run
from benchmark.core import auto_avsr_flops, peaks
from benchmark.core import cell as cells
from benchmark.core.spans import Spans
from benchmark.core.trace import Trace
from lipsync_tpu_torch.utils import profiling
from lipsync_tpu_torch.utils.profiling import SpanRecord

CELL = "auto_avsr.bulk_av_pcm_windows"
NAMES = ("mfu.avsr_bulk", "auto_avsr.video_ms.avsr_bulk",
         "auto_avsr.audio_ms.avsr_bulk", "auto_avsr.conformer_ms.avsr_bulk",
         "auto_avsr.conformer_mfu.avsr_bulk", "k5_swish_stem_roofline")
MS = 1_000_000  # ns
CONFIG = json.loads((cells.ROOT / "benchmark/configs/auto_avsr.json")
                    .read_text())


def reader(name):
    return cells.load_module(cells.metric_path(name), f"m.{name}")


def rec(i, name, t0_ms, t1_ms, parent=None, device_ms=None):
    return SpanRecord(i, parent, parent or i, name, int(t0_ms * MS),
                      int(t1_ms * MS),
                      None if device_ms is None else device_ms / 1e3)


def records():
    """Three groups' forwards, the first before the window: each an
    ``engine.forward`` holding the video, stem, audio, both encoder and
    fusion spans."""
    out = []
    for g, at in enumerate((700, 1100, 1500)):
        f = 10 * (g + 1)
        out += [rec(f, "engine.forward", at, at + 200, parent=100,
                    device_ms=190),
                rec(f + 1, "auto_avsr.video", at, at + 100, parent=f,
                    device_ms=100 + 10 * g),
                rec(f + 2, "auto_avsr.stem", at, at + 5, parent=f + 1,
                    device_ms=5),
                rec(f + 3, "auto_avsr.video_encoder", at + 100, at + 130,
                    parent=f, device_ms=30 + 2 * g),
                rec(f + 4, "auto_avsr.audio", at + 130, at + 150, parent=f,
                    device_ms=15 + g),
                rec(f + 5, "auto_avsr.audio_encoder", at + 150, at + 180,
                    parent=f, device_ms=31 + 2 * g),
                rec(f + 6, "auto_avsr.fusion", at + 180, at + 200, parent=f,
                    device_ms=4)]
    return out


class FakeTrace(Trace):
    """A trace whose window holds ``launches`` K5 launches of ``ms`` each."""

    def __init__(self, launches=0, ms=0.0):
        super().__init__(False)
        self.window = (1000 * MS, 2000 * MS)
        self.kernels = [(1000 * MS + i * 10 * MS,
                         1000 * MS + i * 10 * MS + int(ms * MS),
                         "void (anonymous namespace)::av_stem_kernel<true, "
                         "true>(...)") for i in range(launches)]


def view(device="cuda", trace=None):
    ctx = types.SimpleNamespace(config=CONFIG,
                                device=types.SimpleNamespace(type=device))
    return run.View(ctx, {"windows": 2048, "elapsed": 2.0},
                    trace or FakeTrace())


POSITIONS = 256 * 96 * 44 * 44  # one group's conv output positions


@pytest.fixture
def kept(monkeypatch):
    state = {"records": records(),
             "counters": {"auto_avsr.encoder_tokens": 2 * 256 * 96,
                          "auto_avsr.stem_calls": 2,
                          "auto_avsr.stem_outputs": 2 * POSITIONS}}
    monkeypatch.setattr(profiling, "records", lambda: list(state["records"]))
    monkeypatch.setattr(profiling, "counters",
                        lambda: dict(state["counters"]))
    return state


def test_readers(kept):
    v = view(trace=FakeTrace(launches=2, ms=4.0))
    # The window holds groups 2 and 3: video 110 and 120 ms, audio 16 and
    # 17, the two encoders 32 + 33 and 34 + 35; the median of two is their
    # mean.
    assert reader(NAMES[1]).read(v) == pytest.approx(115.0)
    assert reader(NAMES[2]).read(v) == pytest.approx(16.5)
    assert reader(NAMES[3]).read(v) == pytest.approx(67.0)
    per_token = auto_avsr_flops.encoder_flops_per_token(CONFIG["model"])
    want = 100 * 2 * 2 * 256 * 96 * per_token / 0.134 / peaks.peak("bf16")
    assert reader(NAMES[4]).read(v) == pytest.approx(want)
    per_window = auto_avsr_flops.forward_flops(CONFIG["model"])
    want = 100 * 2048 * per_window / 2.0 / peaks.peak("bf16")
    assert reader(NAMES[0]).read(v) == pytest.approx(want)
    least = POSITIONS * max(40 / 3.35e12, 2 * 245 * 64 / 989e12)
    assert reader(NAMES[5]).read(v) == pytest.approx(
        100 * least / 4e-3, rel=1e-6)
    assert reader(NAMES[5]).read(v) < 100


@pytest.mark.parametrize("absent", ["no_spans", "no_device", "no_counter",
                                    "old_program", "cpu"])
def test_nothing_to_read_gives_none(kept, monkeypatch, absent):
    """A window without the spans, spans without device times (the CPU),
    no counter, or a program without the recorder (the parent, which has
    no such model): the span readers give None, and so do the counter
    readers; ``mfu.avsr_bulk`` reads the host clock and is None only off
    the card."""
    v = view(trace=FakeTrace(launches=2, ms=4.0))
    if absent == "no_spans":
        kept["records"] = [r for r in kept["records"]
                           if not r.name.startswith("auto_avsr.")]
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
        v = view(device="cpu", trace=FakeTrace())
    spans_there = absent == "no_counter"
    for name in NAMES[1:4]:
        assert (reader(name).read(v) is not None) == spans_there, name
    assert reader(NAMES[4]).read(v) is None
    assert (reader(NAMES[5]).read(v) is not None) == (
        absent in ("no_spans", "no_device"))
    assert (reader(NAMES[0]).read(v) is not None) == (absent != "cpu")


def test_flops_are_the_layer_equations():
    """One encoder's count a token: per block the two FFNs (2 x 2 x D x
    F), the four D x D projections, the positional projection over the
    2T - 1 table rows (shared by the window's T tokens), attention's three
    T x D (ac, PV) and (2T - 1) x D (bd) products, the pointwise
    convolutions (D x 2D, D x D) and the depthwise taps (D x K); 2 FLOPs a
    multiply-add. The whole window: ~155 GFLOP, under half of it in the
    two encoders."""
    m = CONFIG["model"]
    d, f, t = m["adim"], m["eunits"], m["video_frames"]
    k, n = m["cnn_module_kernel"], m["elayers"]
    block = (2 * 2 * 2 * d * f + 2 * 4 * d * d
             + 2 * d * d * (2 * t - 1) / t
             + 2 * (2 * t * d + (2 * t - 1) * d)
             + 2 * (2 * d * d + d * d) + 2 * d * k)
    assert auto_avsr_flops.encoder_flops_per_token(m) == pytest.approx(
        n * block, rel=1e-12)
    total = auto_avsr_flops.forward_flops(m)
    assert 150e9 < total < 160e9
    assert 0.40 < 2 * t * n * block / total < 0.50


def test_listed_as_one_cell():
    """One configuration, one one-chip cell and the six readers;
    ``windows_per_s`` is its end-to-end metric."""
    bench = cells.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}["auto_avsr"]
    assert entry["file"] == "benchmark/configs/auto_avsr.json"
    assert entry["source"] == CONFIG["source"]
    assert entry["reduced"] == CONFIG["reduced"] == ["decoder", "ctc"]
    w = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "auto_avsr", "bulk_av_pcm_windows", 1)
    e2e = [m["name"] for m in cells.resolve(bench, CELL).end_to_end]
    assert sorted(e2e) == ["setup_s", "windows_per_s"]
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        assert layer[name]["layer"] == ("kernels" if "roofline" in name
                                        else "model step")
        assert layer[name]["moves"] == "windows_per_s"
        assert layer[name]["workloads"] == [CELL]
        assert cells.metric_path(name).is_file()


def test_readers_listed_for_the_cell_alone():
    bench = cells.load_benchmark()
    for w in (w["name"] for w in bench["workloads"]):
        readers = cells.resolve(bench, w).readers
        for name in NAMES:
            assert (name in readers) == (w == CELL), (w, name)


def test_config_file():
    """The configuration as run: the published widths under the keys the
    model takes, the decoder and CTC alone cut, ~376 M parameters by its
    own reference and as many in the model's parts (video front end,
    audio front end, the two conformers, fusion and head), and a
    precision for each of its four parts."""
    from benchmark.reference import auto_avsr as ref
    from lipsync_tpu_torch.models.auto_avsr import AutoAVSR, AutoAVSRConfig

    assert CONFIG["name"] == "auto_avsr"
    assert CONFIG["reduced"] == ["decoder", "ctc"]
    m = CONFIG["model"]
    pub = CONFIG["published"]
    for key in ("adim", "aheads", "eunits", "elayers", "cnn_module_kernel",
                "fusion_hdim"):
        assert m[key] == pub[key], key
    assert (m["adim"], m["aheads"], m["eunits"], m["elayers"]) == (
        768, 12, 3072, 12)
    assert (pub["aux_adim"], pub["aux_elayers"]) == (768, 12)
    assert m["audio_frames"] == 4 * m["video_frames"] == 384
    table = ref.param_shapes(m)
    n = sum(math.prod(s) for s in table.values())
    assert 3.75e8 < n < 3.77e8
    with torch.device("meta"):
        model = AutoAVSR(AutoAVSRConfig(**m))
    parts = {"encoder.frontend": model.encoder.frontend,
             "encoder.embed": model.encoder.embed,
             "aux_encoder.frontend": model.aux_encoder.frontend,
             "aux_encoder.embed": model.aux_encoder.embed,
             "fusion": model.fusion, "head": model.head}
    counted = sum(v.numel() for p in parts.values()
                  for v in p.state_dict().values())
    for enc in (model.encoder, model.aux_encoder):
        counted += sum(v.numel() for v in enc.encoders.state_dict().values())
        counted += sum(v.numel() for v in enc.after_norm.state_dict()
                       .values())
    assert counted == n
    assert set(CONFIG["precision"]) == set(ref.PARTS)
    assert CONFIG["limits"]["logit_gap"] > 0
    assert CONFIG["mfu_peak"]["serve"] == "bf16"
    for key in ("head", "weights", "ffn_activation", "pcm_normalisation",
                "fusion_order", "window", "precision", "state_dict_names"):
        assert CONFIG["assumed"][key]


# A small model for the CPU: the ResNets at their fixed widths, 2 blocks an
# encoder of width 64, 4 heads, FFN 128, fusion 128, 8 frames of 48 pixels.
SMALL_MODEL = {"video_frames": 8, "crop_size": 48, "audio_frames": 32,
               "adim": 64, "aheads": 4, "eunits": 128, "elayers": 2,
               "fusion_hdim": 128}
TINY = {"pool": 8, "call": 4, "group": 2}
SEED = 2 ** 31 + 11


# The published widths at the small model's length: where the control's
# reading is of the card's order (the small widths carry less rounding).
WIDE_MODEL = {k: SMALL_MODEL[k] for k in ("video_frames", "crop_size",
                                          "audio_frames")}


def cell(model=SMALL_MODEL):
    c = cells.resolve(cells.load_benchmark(), CELL)
    c.config = dict(c.config, model=dict(c.config["model"], **model))
    return c


def rehearse(trace=False, faults=()):
    out = io.StringIO()
    run.execute(cell(), SEED, 1.0, trace, torch.device("cpu"),
                time.perf_counter(), faults=faults, scale=TINY, out=out)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_last_line(trace):
    """The mix at a small size on the CPU: correct, every end-to-end metric
    (untraced), only the cell's per-layer metrics (traced: on the CPU the
    device metrics have nothing to read)."""
    line = rehearse(trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    c = cells.resolve(cells.load_benchmark(), CELL)
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    else:
        assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}


def test_an_altered_answer_is_not_correct():
    assert rehearse(faults=("altered_answer",))["correct"] is False


def test_the_control_is_not_correct_and_each_part_read_alone():
    """At the published widths (8 frames of 48 pixels): the program's
    reading is within the limit and the control's (the reference one step
    below the configuration's precision) above it. The ``readings --part``
    comparison with int8 in each part alone reads a gap of its own."""
    from benchmark.readings import one_part
    from benchmark.reference import auto_avsr as ref

    c = cell(WIDE_MODEL)
    ctx = run.Context(c.config, SEED, 0.5, torch.device("cpu"),
                      Spans(False), scale=TINY)
    state = c.mix.setup(ctx)
    c.mix.window(state, ctx)
    assert all(v <= lim for _, v, lim in c.mix.check(state, ctx))
    assert all(v > lim for _, v, lim in c.mix.control(state, ctx))
    for part in ref.PARTS:
        got = c.mix.control(state, ctx, one_part(
            c.config, c.mix.PRECISION, f"{part}:bf16:int8"))
        assert [n for n, _, _ in got] == ["logit_gap"]
        assert all(v == v and v > 0 for _, v, _ in got), part


def test_speechish_pcm():
    """The pool's PCM: seeded (the same seed, the same samples), each
    window at its own level in [0.02, 0.3] RMS, rising and falling."""
    from benchmark.traffic import bulk_av_pcm_windows as mix

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return mix.speechish(gen, 4, 16000, torch.device("cpu"))

    a, b = draw(5), draw(5)
    assert torch.equal(a, b) and not torch.equal(a, draw(6))
    rms = a.pow(2).mean(dim=-1).sqrt().flatten()
    assert ((rms >= 0.02 - 1e-6) & (rms <= 0.3 + 1e-6)).all()
    assert len(set(rms.tolist())) == 4
    frames = a.view(4, 100, 160).pow(2).mean(dim=-1).sqrt()
    assert (frames.max(dim=1).values > 3 * frames.min(dim=1).values).all()
