"""Each cell rehearsed on the CPU at a tiny size: the last line it prints,
the faults and the control that must come out not correct, and what a run
may and may not load."""

import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.core import cell as cells
from benchmark.core.report import FORBIDDEN, forbidden_modules
from benchmark.core.spans import Spans

BENCH = cells.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
TINY_MODEL = {"video_frames": 8, "crop_size": 48, "audio_frames": 32}
TINY = {"pool": 8, "call": 4, "group": 2, "clips": 8, "frames": 12,
        "batch": 4}
SEED = 2 ** 31 + 11


def tiny_cell(workload):
    c = cells.resolve(BENCH, workload)
    c.config = dict(c.config, model=dict(c.config["model"], **TINY_MODEL))
    return c


def rehearse(workload, trace=False, faults=(), seconds=1.0):
    out = io.StringIO()
    run.execute(tiny_cell(workload), SEED, seconds, trace,
                torch.device("cpu"), time.perf_counter(), faults=faults,
                scale=TINY, out=out)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_last_line_is_well_formed(workload, trace):
    line = rehearse(workload, trace)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    c = cells.resolve(BENCH, workload)
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
        for m in c.end_to_end:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
            assert line["metrics"][m["name"]]["value"] > 0
    else:
        # On the CPU the device metrics have nothing to read.
        assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]


@pytest.mark.parametrize("workload, fault", [
    ("flagship.bulk_windows", "altered_answer"),
    ("flagship_int8.bulk_windows", "altered_answer"),
    ("flagship.train_b32", "unchanged_state"),
    ("flagship.train_b32", "half_batch"),
])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    assert rehearse(workload, faults=(fault,))["correct"] is False


def test_a_fault_only_in_the_window_is_not_correct():
    """The train cell compares the window's own first steps: a step that
    leaves half the batch out only once set-up is over is caught."""
    c = tiny_cell("flagship.train_b32")
    ctx = run.Context(c.config, SEED, 0.5, torch.device("cpu"), Spans(False),
                      scale=TINY)
    state = c.mix.setup(ctx)
    inner = state["step"]
    state["step"] = lambda st, b: inner(
        st, {k: v[: v.shape[0] // 2] for k, v in b.items()})
    c.mix.window(state, ctx)
    assert any(v > lim for _, v, lim in c.mix.check(state, ctx))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_one_part_of_the_precision_read(workload):
    """``readings --part``: the configuration's precision with one part
    changed, held to the same comparison as the control."""
    from benchmark.readings import one_part

    c = tiny_cell(workload)
    low = one_part(c.config, c.mix.PRECISION, "visual_low:bf16:bf16")
    assert low["visual_low"] == {"act": "bf16", "math": "bf16"}
    assert {k: v for k, v in low.items() if k != "visual_low"} == {
        k: v for k, v in c.config[c.mix.PRECISION].items()
        if k != "visual_low"}
    ctx = run.Context(c.config, SEED, 0.5, torch.device("cpu"), Spans(False),
                      scale=TINY)
    state = c.mix.setup(ctx)
    c.mix.window(state, ctx)
    program = c.mix.check(state, ctx)
    got = c.mix.control(state, ctx, low)
    assert [n for n, _, _ in got] == [n for n, _, _ in program]
    assert all(v == v and v > 0 for _, v, _ in got)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    c = tiny_cell(workload)
    ctx = run.Context(c.config, SEED, 0.5, torch.device("cpu"), Spans(False),
                      scale=TINY)
    state = c.mix.setup(ctx)
    c.mix.window(state, ctx)
    program = c.mix.check(state, ctx)
    control = c.mix.control(state, ctx)
    assert all(v <= lim for _, v, lim in program)
    assert any(v > lim for _, v, lim in control)


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card(card, workload):
    """Each cell at its own size for a few seconds on the card: correct,
    every end-to-end metric reported, the card named."""
    out = io.StringIO()
    run.execute(cells.resolve(BENCH, workload), SEED, 3.0, False, card,
                time.perf_counter(), out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {
        m["name"] for m in cells.resolve(BENCH, workload).end_to_end}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code = run.main(["--workload", WORKLOADS[0], "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert code == 2 and capsys.readouterr().out == ""


def test_forbidden_names_compare_whole():
    assert forbidden_modules(["lipsync_tpu_torch.models", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["lipsync_tpu.models", "jax.numpy"]) == [
        "jax", "lipsync_tpu"]
    assert "lipsync_tpu" in FORBIDDEN


ISOLATION = """
import sys, time, io, torch
sys.path.insert(0, {root!r})
from benchmark.tests.test_bench_rehearsal import rehearse
from benchmark.core.report import forbidden_modules
for w in {workloads!r}:
    rehearse(w, trace=True)
found = forbidden_modules()
print("FOUND", found)
sys.exit(1 if found else 0)
"""


def test_a_run_loads_no_jax():
    """A fresh process rehearses every cell, traced, then holds no module
    whose top-level name is JAX's or the JAX package's."""
    code = ISOLATION.format(root=str(cells.ROOT), workloads=WORKLOADS)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                          capture_output=True, text=True, timeout=900,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "FOUND []" in proc.stdout


def test_reference_imports_nothing_of_the_program():
    for path in (cells.HERE / "reference").glob("*.py"):
        text = path.read_text()
        assert "lipsync_tpu" not in text, path
        assert "import jax" not in text and "from jax" not in text, path


def test_no_file_reads_the_old_tpu_benchmark():
    old = ("bench.py", "BENCH_r", "BASELINE.json", "MULTICHIP_")
    for path in cells.HERE.rglob("*"):
        if path.suffix not in (".py", ".json") or "tests" in path.parts:
            continue
        text = path.read_text()
        for name in old:
            assert name not in text, (path, name)
