"""The port's benchmark tools against the JAX package's scripts of the same
names, on the CPU: ``bench_int8``, ``bench_fold``, ``diagnose_int8``,
``bench_train_scaling``, ``bench_serving`` (stub model, real HTTP),
``bench_coalesce_r5``, ``bench_predictor`` and ``bench_haar``. Each
report carries the JAX script's keys.

Bounds: the fp32 probabilities of the served ("conv") and unfolded arms
within 1e-5 of the JAX package's on the same weights and batch (JAX at
highest matmul precision: XLA:CPU's default rounds convolutions to
~1e-3); each tool's |dprob| within its arm's bound (int8 5e-3,
``tests/test_ops.py:240``; fold 1e-3, ``:336``). int8 agreement across
the packages holds only to the quantization step (ROADMAP C), so the int8
arm is held to its bound, not to JAX. The int8 accumulators of
``diagnose_int8``'s conv stage equal XLA's int32 convolution of the same
int8 tensors exactly. Host-only results (detections, verdicts, cells,
request counts) are equal.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_coalesce_r5 as j_coalesce  # noqa: E402
import bench_fold as j_fold  # noqa: E402
import bench_haar as j_haar  # noqa: E402
import bench_int8 as j_int8  # noqa: E402
import bench_predictor as j_predictor  # noqa: E402
import bench_serving as j_serving  # noqa: E402
import bench_train_scaling as j_scaling  # noqa: E402
import diagnose_int8 as j_diag  # noqa: E402

import lipsync_tpu.inference.engine as j_engine_mod  # noqa: E402
import lipsync_tpu.inference.predictor as j_predictor_mod  # noqa: E402
import lipsync_tpu.models as j_models  # noqa: E402
import lipsync_tpu.preprocessing.ingest as j_ingest  # noqa: E402
import lipsync_tpu.training.steps as j_steps  # noqa: E402
from lipsync_tpu_torch import models as port_models  # noqa: E402
from lipsync_tpu_torch.inference import predictor as predictor_mod  # noqa: E402
from lipsync_tpu_torch.models import artifact as artifact_mod  # noqa: E402
from lipsync_tpu_torch.models import lip_sync_model  # noqa: E402
from lipsync_tpu_torch.models.bridge import variables_to_state_dict  # noqa: E402
from lipsync_tpu_torch.preprocessing import ingest  # noqa: E402
from lipsync_tpu_torch.tools import bench_coalesce_r5  # noqa: E402
from lipsync_tpu_torch.tools import bench_fold  # noqa: E402
from lipsync_tpu_torch.tools import bench_haar  # noqa: E402
from lipsync_tpu_torch.tools import bench_int8  # noqa: E402
from lipsync_tpu_torch.tools import bench_predictor  # noqa: E402
from lipsync_tpu_torch.tools import bench_serving  # noqa: E402
from lipsync_tpu_torch.tools import bench_train_scaling  # noqa: E402
from lipsync_tpu_torch.tools import diagnose_int8  # noqa: E402
from lipsync_tpu_torch.tools.common import StubEngine  # noqa: E402
from lipsync_tpu_torch.training import steps as steps_mod  # noqa: E402
from tests.torch_parity import NARROW, seeded_pair  # noqa: E402

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
SMALL = dict(video_frames=8, crop_size=48, mel_bins=80, audio_frames=32)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


class _Recorder:
    """The JAX script's ``np`` with every ``asarray`` result kept: its
    benches read each forward's logits back through ``np.asarray``."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def asarray(self, x, *a, **k):
        out = np.asarray(x, *a, **k)
        self.seen.append(out)
        return out


TINY = dict(video_frames=8, crop_size=32, audio_frames=32)  # --tiny


@pytest.fixture(scope="module")
def tiny_init():
    """What the JAX A/B scripts' ``LipSyncModel(cfg).init(PRNGKey(0),
    ...)`` makes under ``--tiny`` (``ModelConfig()``'s widths), computed
    once and jitted (an eager init dispatches op by op)."""
    from lipsync_tpu.models import ModelConfig as JConfig

    cfg = JConfig(**TINY)
    v = jnp.zeros((1, cfg.video_frames, cfg.crop_size, cfg.crop_size, 3))
    a = jnp.zeros((1, cfg.mel_bins, cfg.audio_frames, 1))
    return jax.jit(lambda k, vv, aa: j_models.LipSyncModel(cfg).init(
        k, vv, aa))(jax.random.PRNGKey(0), v, a)


@pytest.fixture
def jax_init(monkeypatch, tiny_init):
    """The JAX scripts' init returns :func:`tiny_init`; the port's weights
    are the same, through the bridge."""

    def init(self, *a, **k):
        assert self.config.crop_size == TINY["crop_size"]
        return tiny_init

    monkeypatch.setattr(j_models.LipSyncModel, "init", init)
    return variables_to_state_dict(tiny_init)


def _jax_ab(monkeypatch, capsys, module, argv):
    """Runs a JAX A/B script at highest precision; its printed report and
    each arm's logits (warm, then one timed call per arm)."""
    rec = _Recorder()
    monkeypatch.setattr(module, "np", rec)
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    with jax.default_matmul_precision("highest"):
        module.main()
    report = json.loads(capsys.readouterr().out)
    logits = [x for x in rec.seen if x.ndim == 1]
    return report, logits[1], logits[3]


def _port_ab(monkeypatch, module):
    """Wraps the port tool's ``forward_ab``: its per-arm results."""
    seen = {}
    real = module.forward_ab

    def recording(*a, **k):
        seen.update(real(*a, **k))
        return seen

    monkeypatch.setattr(module, "forward_ab", recording)
    return seen


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def test_bench_int8_against_the_jax_script(monkeypatch, capsys, jax_init):
    argv = ["--tiny", "--batch", "2", "--iters", "1"]
    want, j_conv, _ = _jax_ab(monkeypatch, capsys, j_int8, argv)
    arms = _port_ab(monkeypatch, bench_int8)
    got = bench_int8.main([*argv, *CPU], variables=jax_init)
    assert json.loads(capsys.readouterr().out) == got
    assert set(got) == set(want)
    assert (got["batch"], got["platform"], got["dtype"]) == (
        want["batch"], want["platform"], want["dtype"]) == (2, "cpu",
                                                            "float32")
    assert np.abs(arms["conv"]["prob"] - _sigmoid(j_conv)).max() <= 1e-5
    assert want["max_dprob"] <= 5e-3
    assert got["max_dprob"] <= 5e-3
    assert got["max_dprob"] == np.abs(
        arms["conv"]["prob"] - arms["int8"]["prob"]).max()


def test_bench_fold_against_the_jax_script(monkeypatch, capsys, jax_init,
                                           tmp_path):
    argv = ["--tiny", "--batch", "2", "--iters", "1"]
    want, j_seq, j_folded = _jax_ab(monkeypatch, capsys, j_fold,
                                    [*argv, "--cpu"])
    weights = tmp_path / "jax_init.pth"
    torch.save(jax_init, weights)
    arms = _port_ab(monkeypatch, bench_fold)
    got = bench_fold.main([*argv, "--model-path", str(weights), *CPU])
    capsys.readouterr()
    assert set(got) == set(want)
    assert got["weights"] == str(weights) and want["weights"] == "random"
    for name, j_logits in (("sequential", j_seq), ("folded", j_folded)):
        assert np.abs(arms[name]["prob"] - _sigmoid(j_logits)).max() <= 1e-5
    assert want["max_dprob"] <= 1e-3 and got["max_dprob"] <= 1e-3


def test_a_raising_hf_stem_ends_bench_fold(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("hf_stem kernel launch failed: cudaError 700")

    monkeypatch.setattr(artifact_mod, "hf_stem", broken)
    with pytest.raises(RuntimeError, match="hf_stem kernel"):
        bench_fold.main(["--tiny", "--batch", "2", "--iters", "1", *CPU])


def test_diagnose_int8_report_has_the_jax_keys(monkeypatch, capsys,
                                               tmp_path):
    argv = ["--batch", "1", "--iters", "1", "--max-dim", "512",
            "--shapes", "a_l2"]
    monkeypatch.setattr(sys, "argv", ["diagnose_int8.py", *argv, "--cpu",
                                      "--out", str(tmp_path / "j.json")])
    j_diag.main()
    want = json.loads((tmp_path / "j.json").read_text())
    got = diagnose_int8.main([*argv, *CPU, "--out",
                              str(tmp_path / "p.json")])
    assert json.loads((tmp_path / "p.json").read_text()) == got
    assert set(want) <= set(got)
    assert got["v5e_bf16_peak_tops"] is got["v5e_int8_peak_tops"] is None
    for stage in ("gemm", "conv", "quant"):
        assert set(want[stage]) == set(got[stage])
        assert len(got[stage]["rows"]) == len(want[stage]["rows"])
        for g, w in zip(got[stage]["rows"], want[stage]["rows"]):
            assert set(w) <= set(g)
            assert g.get("shape") == w.get("shape")
            assert g.get("n") == w.get("n")
    assert all(r["int8_acc_equals_twin"] for r in got["conv"]["rows"])


@pytest.mark.parametrize("name", ["v_l3", "a_l2", "a_stem"])
def test_diagnose_int8_accumulators_equal_xla(name):
    shape = next(s for s in diagnose_int8.CONV_SHAPES if s[0] == name)
    _, ishape, ks, cin, cout, strides = shape
    x, k, x8, k8 = diagnose_int8.conv_operands(
        np.random.RandomState(1), ishape, ks, cin, cout, 2)
    want = np.asarray(j_diag._conv(jnp.asarray(x8), jnp.asarray(k8),
                                   strides, jnp.int32))
    got = diagnose_int8.int8_prequant(torch.from_numpy(x8),
                                      torch.from_numpy(k8), strides)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ── bench_train_scaling ──────────────────────────────────────────────────

@pytest.fixture
def jax_scaling(monkeypatch):
    """The JAX script with its model and step stubbed out (the keys test
    needs its rows, not its XLA compiles); ``fail_at`` makes the step
    raise at that batch."""
    from lipsync_tpu.models import ModelConfig as JConfig

    fail = {}

    class Model:
        def __init__(self, *a, **k):
            pass

        def init(self, *a, **k):
            return {"params": {"w": jnp.zeros(2)}, "batch_stats": {}}

    def make_step(model, optimizer, augment_cfg=None):
        def step(state, batch):
            if batch["visual"].shape[0] == fail.get("batch"):
                raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
            return state, {"loss": jnp.sum(batch["audio"])}
        return step

    monkeypatch.setattr(j_models, "LipSyncModel", Model)
    monkeypatch.setattr(j_models, "ModelConfig", lambda: JConfig(**SMALL))
    monkeypatch.setattr(j_steps, "make_train_step", make_step)
    monkeypatch.setattr(j_scaling.jax, "jit", lambda f, **k: f)
    return fail


@pytest.fixture
def small_port(monkeypatch):
    """The port's ``ModelConfig()`` at the small geometry and the parity
    tests' narrow widths (``tests/torch_parity.py::NARROW``): a train step
    at full width costs seconds on one CPU thread."""
    cfg = lip_sync_model.ModelConfig(**{**NARROW, **SMALL})
    monkeypatch.setattr(port_models, "ModelConfig", lambda: cfg)
    return cfg


def _port_step_failing_at(monkeypatch, batch, exc):
    real = steps_mod.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def failing(state, b, *args, **kw):
            if b["visual"].shape[0] == batch:
                raise exc
            return step(state, b, *args, **kw)
        return failing

    monkeypatch.setattr(steps_mod, "make_train_step", make)


def _run_jax_scaling(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["bench_train_scaling.py", *argv])
    j_scaling.main()
    return json.loads(capsys.readouterr().out)


def test_bench_train_scaling_rows_as_the_jax_script(
        monkeypatch, capsys, jax_scaling, small_port):
    argv = ["--batches", "2,4", "--iters", "1"]
    want = _run_jax_scaling(monkeypatch, capsys, [*argv, "--cpu"])
    got = bench_train_scaling.main([*argv, *CPU])
    assert json.loads(capsys.readouterr().out) == got
    assert set(got) == set(want)
    assert got["dtype"] == "float32" and got["platform"] == "cpu"
    assert [r["batch"] for r in got["rows"]] == [2, 4]
    assert [set(r) for r in got["rows"]] == [set(r) for r in want["rows"]]
    for r in got["rows"]:
        assert r["step_ms"] > 0 and r["flops_per_step"] > 0
        assert r["mfu"] is r["hbm_bytes_per_step"] is r["hbm_util"] is None
    # FLOPs grow with the batch (a step is per-sample work).
    assert got["rows"][1]["flops_per_step"] == pytest.approx(
        2 * got["rows"][0]["flops_per_step"], rel=1e-6)


def test_bench_train_scaling_records_out_of_memory_and_goes_on(
        monkeypatch, capsys, jax_scaling, small_port):
    jax_scaling["batch"] = 4
    argv = ["--batches", "4,2", "--iters", "1"]
    want = _run_jax_scaling(monkeypatch, capsys, [*argv, "--cpu"])
    _port_step_failing_at(monkeypatch, 4, torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 300.00 GiB"))
    got = bench_train_scaling.main([*argv, *CPU])
    capsys.readouterr()
    assert [set(r) for r in got["rows"]] == [set(r) for r in want["rows"]]
    assert got["rows"][0] == {"batch": 4, "error": "CUDA out of memory. "
                              "Tried to allocate 300.00 GiB"}
    assert got["rows"][1]["batch"] == 2 and "step_ms" in got["rows"][1]


def test_bench_train_scaling_ends_on_any_other_failure(monkeypatch,
                                                       small_port):
    _port_step_failing_at(monkeypatch, 2, RuntimeError(
        "int8_conv kernel launch failed: cudaError 700"))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bench_train_scaling.main(["--batches", "2,4", "--iters", "1", *CPU])


# ── serving, coalescing, the predictor, haar ─────────────────────────────

def test_bench_serving_stub_over_http_as_the_jax_script(capsys):
    argv = ["--stub-model", "--requests", "4", "--concurrency", "2",
            "--n-clips", "2", "--clip-seconds", "1.0"]
    want = j_serving.main(argv)
    got = bench_serving.main(argv)
    capsys.readouterr()
    assert set(got) == set(want)
    for key in ("requests", "errors", "concurrency", "clip_seconds",
                "stub_model", "detection_stride", "coalesce", "metric",
                "unit"):
        assert got[key] == want[key], key
    assert got["requests"] == 4 and got["errors"] == 0


class _JaxStubEngine:
    """The port's ``StubEngine`` scores in numpy; the JAX package's
    ``CoalescingEngine`` takes it as is."""

    max_batch = 256

    def __init__(self):
        self._stub = StubEngine()
        self.config = self._stub.config
        self.calibrator = self._stub.calibrator

    def score_logits(self, visual, audio):
        return self._stub.score_logits(visual, audio)

    def score_probs(self, visual, audio):
        return self._stub.score_probs(visual, audio)


def test_bench_coalesce_r5_cells_as_the_jax_script(monkeypatch, capsys,
                                                   tmp_path):
    argv = ["--model-path", str(tmp_path / "stub.pth"), "--requests", "6",
            "--windows-per-request", "2", "--concurrencies", "1,2"]
    monkeypatch.setattr(j_engine_mod, "load_engine",
                        lambda *a, **k: _JaxStubEngine())
    monkeypatch.setattr(sys, "argv", ["bench_coalesce_r5.py", *argv,
                                      "--out", str(tmp_path / "j.json")])
    j_coalesce.main()
    want = json.loads((tmp_path / "j.json").read_text())
    got = bench_coalesce_r5.main([*argv, "--out", str(tmp_path / "p.json"),
                                  *CPU], engine=_JaxStubEngine())
    assert json.loads((tmp_path / "p.json").read_text()) == got
    capsys.readouterr()
    assert set(got) == set(want)

    def cells(report):
        return [(c["concurrency"], c["coalesce"], c["requests"],
                 c["windows_per_request"], tuple(sorted(c)))
                for c in report["cells"]]

    assert cells(got) == cells(want)


def test_bench_predictor_verdicts_as_the_jax_script(monkeypatch, capsys,
                                                    tmp_path):
    """Both packages' predictors on the same bridged seeded weights at the
    small geometry, the same clips (each written and read by its own
    package) and the default detector ladder."""
    from lipsync_tpu.inference.predictor import Predictor as JPredictor
    from lipsync_tpu.models import ModelConfig as JConfig
    from lipsync_tpu_torch.inference.predictor import Predictor

    model, cfg, variables, jcfg = seeded_pair(0, **SMALL)
    weights = tmp_path / "seeded.pth"
    torch.save(model.state_dict(), weights)
    verdicts = {"jax": [], "port": []}

    def recording(cls, key, **fixed):
        class Rec(cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **{**k, **fixed})

            def predict(self, path):
                out = super().predict(path)
                verdicts[key].append(out["verdict"])
                return out
        return Rec

    monkeypatch.setattr(j_ingest, "read_video", ingest.read_video)
    monkeypatch.setattr(j_predictor_mod, "Predictor",
                        recording(JPredictor, "jax", model_config=jcfg))
    monkeypatch.setattr(predictor_mod, "Predictor",
                        recording(Predictor, "port", model_config=cfg))
    argv = ["--model-path", str(weights), "--n-clips", "2",
            "--clip-seconds", "2.4", "--repeats", "1"]
    with jax.default_matmul_precision("highest"):
        assert j_predictor.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    got = bench_predictor.main([*argv, *CPU])
    capsys.readouterr()
    assert set(want) <= set(got)
    assert got["pipelined"]["n"] == want["pipelined"]["n"] == 2
    # warm + 2 clips per arm, in the same order on both sides
    assert verdicts["port"] == verdicts["jax"]
    assert got["verdicts"] == {"pipelined": verdicts["port"][1:3],
                               "serialized": verdicts["port"][4:6]}


def test_bench_haar_detections_as_the_jax_script(capsys):
    sys_argv = sys.argv
    try:
        sys.argv = ["bench_haar.py", "--iters", "2", "--height", "240",
                    "--width", "320"]
        j_haar.main()
    finally:
        sys.argv = sys_argv
    want = capsys.readouterr().out
    got = bench_haar.main(["--iters", "2", "--height", "240",
                           "--width", "320"])
    printed = capsys.readouterr().out
    assert f"faces={got['faces']}" in want.splitlines()[0]
    assert printed.splitlines()[0] == want.splitlines()[0]
    assert np.array_equal(
        bench_haar.make_frame(240, 320), j_haar.make_frame(240, 320))
