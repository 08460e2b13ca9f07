"""The port's profilers against the JAX package's scripts of the same
names, on the CPU at ``tests/conftest.py::small_model_config`` geometry:
``profile_forward`` (report keys; the FLOPs of the visual and audio
encoder stages against XLA's cost analysis) and ``profile_host`` (report
keys, frames, frames detected, on the same synthetic clip through each
package's own stages). A raising K2 ends ``profile_forward
--artifact-detail``.

FLOPs: the port counts with ``torch.utils.flop_counter.FlopCounterMode``,
which prices a convolution at every kernel tap of every output, the taps
over the zero padding included. XLA's cost analysis counts only the taps
that land inside the input, plus elementwise work. At this geometry (8
frames, 48 px crops, feature maps down to 3 x 3) the padding is a large
share of the taps, so the two differ by more than 10%: the port's
encoders count 1.40x (visual) and 1.29x (audio) XLA's, and the difference
is all in the one op class they hold, convolution.
:func:`test_encoder_flops_against_xla_cost_analysis` states it so: the
same convolutions counted by in-bounds taps are within 1% under XLA's
total (its excess is the elementwise work), and the port's count is the
full-tap count exactly.
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

import profile_forward as j_forward  # noqa: E402
import profile_host as j_host  # noqa: E402

import lipsync_tpu.preprocessing.ingest as j_ingest  # noqa: E402
from lipsync_tpu.models.audio_encoder import AudioEncoder as JAudio  # noqa: E402
from lipsync_tpu.models.visual_encoder import VisualEncoder as JVisual  # noqa: E402
from lipsync_tpu_torch import models as port_models  # noqa: E402
from lipsync_tpu_torch.models import artifact as artifact_mod  # noqa: E402
from lipsync_tpu_torch.models import lip_sync_model  # noqa: E402
from lipsync_tpu_torch.models.audio_encoder import AudioEncoder  # noqa: E402
from lipsync_tpu_torch.models.visual_encoder import VisualEncoder  # noqa: E402
from lipsync_tpu_torch.preprocessing import ingest  # noqa: E402
from lipsync_tpu_torch.tools import profile_forward, profile_host  # noqa: E402

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
SMALL = dict(video_frames=8, crop_size=48, mel_bins=80, audio_frames=32)


@pytest.fixture
def small_port(monkeypatch):
    """The port's ``ModelConfig()`` at the small geometry."""
    cfg = lip_sync_model.ModelConfig(**SMALL)
    monkeypatch.setattr(port_models, "ModelConfig", lambda: cfg)
    return cfg


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


class _Stub:
    """In the JAX script's place of ``LipSyncModel``: the keys test needs
    its report, not its XLA compiles."""

    def __init__(self, *a, **k):
        pass

    def init(self, *a, **k):
        return {}

    def apply(self, *a, **k):
        return jnp.zeros(())


def test_profile_forward_report_has_the_jax_keys(monkeypatch, capsys,
                                                 small_port):
    from lipsync_tpu.models import ModelConfig as JConfig

    monkeypatch.setattr(j_forward, "ModelConfig",
                        lambda: JConfig(**SMALL))
    monkeypatch.setattr(j_forward, "bench_module",
                        lambda module, *a, **k: (1e-3, 1e9))
    monkeypatch.setattr(j_forward, "_time", lambda *a, **k: 1e-3)
    monkeypatch.setattr(j_forward, "_flops", lambda *a, **k: 1e9)
    monkeypatch.setattr(j_forward, "LipSyncModel", _Stub)
    monkeypatch.setattr(sys, "argv", ["profile_forward.py", "--iters", "1",
                                      "--artifact-detail"])
    j_forward.main()
    want = json.loads(capsys.readouterr().out)

    got = profile_forward.main(["--iters", "1", "--artifact-detail", *CPU])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(got))
    assert _keys(got) == _keys(want)
    assert got["batch"] == want["batch"] == 2
    assert got["platform"] == want["platform"] == "cpu"
    assert got["dtype"] == want["dtype"] == "float32"
    for name, stage in got["stages"].items():
        assert stage["ms"] > 0 and stage["gflops"] > 0, name
        assert stage["mfu"] is None  # the CPU has no published peak
    assert got["full_mfu"] is None
    assert got["sum_of_stages_ms"] == pytest.approx(
        sum(s["ms"] for s in got["stages"].values()))


def _in_bounds_conv_flops(module, *inputs, **kw) -> float:
    """2 x MACs of every convolution of ``module``, counting only the
    kernel taps that land inside the input (XLA's convention)."""

    def taps(n, k, s, p):
        out = (n + 2 * p - k) // s + 1
        return sum(sum(0 <= o * s - p + kk < n for kk in range(k))
                   for o in range(out))

    total = [0]

    def hook(mod, inp, out):
        x, w = inp[0], mod.weight
        t = 1
        for d in range(w.dim() - 2):
            t *= taps(x.shape[2 + d], w.shape[2 + d], mod.stride[d],
                      mod.padding[d])
        total[0] += 2 * x.shape[0] * t * w.shape[0] * w.shape[1]

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    with torch.no_grad():
        module(*inputs, **kw)
    for h in hooks:
        h.remove()
    return float(total[0])


def _xla_flops(module, x, **kw) -> float:
    """The JAX script's ``_flops`` (compiled cost analysis) of ``module``
    on ``x``, its variables as shapes only."""
    shapes = jax.eval_shape(lambda k, a: module.init(k, a, **kw),
                            jax.random.PRNGKey(0), x[:1])
    fn = jax.jit(lambda vs, a: module.apply(vs, a, **kw))
    return j_forward._flops(fn, shapes, x)


@pytest.mark.parametrize("stage", ["visual_encoder", "audio_encoder"])
def test_encoder_flops_against_xla_cost_analysis(small_port, stage):
    cfg = small_port
    rng = np.random.RandomState(0)
    visual = rng.rand(2, cfg.video_frames, cfg.crop_size, cfg.crop_size,
                      3).astype(np.float32)
    audio = (rng.rand(2, cfg.mel_bins, cfg.audio_frames, 1) * 80
             - 80).astype(np.float32)
    if stage == "visual_encoder":
        x, kw = visual, {"return_map": True}
        jax_module = JVisual(feature_dim=cfg.visual_feature_dim,
                             dtype=jnp.float32)
        port_module = VisualEncoder(cfg.visual_feature_dim).eval()
    else:
        x, kw = audio, {}
        jax_module = JAudio(feature_dim=cfg.audio_feature_dim,
                            preserve_audio_temporal=True, dtype=jnp.float32)
        port_module = AudioEncoder(cfg.audio_feature_dim,
                                   preserve_audio_temporal=True).eval()
    xla = _xla_flops(jax_module, jnp.asarray(x), **kw)
    xt = torch.from_numpy(x)
    port = profile_forward.flops_per_call(
        lambda rows: port_module(xt[:rows], **kw), 2)
    in_bounds = _in_bounds_conv_flops(port_module, xt, **kw)

    # One op class (convolution); the full-tap count is the port's report.
    assert port / xla > 1.1  # beyond 10%: the padding taps
    assert in_bounds <= xla <= in_bounds * 1.01
    full = _full_tap_conv_flops(port_module, xt, **kw)
    assert port == full


def _full_tap_conv_flops(module, *inputs, **kw) -> float:
    """2 x MACs of every convolution, every kernel tap of every output."""
    total = [0]

    def hook(mod, inp, out):
        w = mod.weight
        total[0] += 2 * out.numel() * w[0].numel()

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    with torch.no_grad():
        module(*inputs, **kw)
    for h in hooks:
        h.remove()
    return float(total[0])


def test_a_raising_hf_stem_ends_profile_forward(monkeypatch, small_port):
    def broken(*a, **k):
        raise RuntimeError("hf_stem kernel launch failed: cudaError 700")

    monkeypatch.setattr(artifact_mod, "hf_stem", broken)
    with pytest.raises(RuntimeError, match="hf_stem kernel"):
        profile_forward.main(["--iters", "1", "--artifact-detail", *CPU])


def test_profile_host_against_the_jax_script(monkeypatch, capsys):
    """Both read the clip through the port's reader (the native RGB
    conversion leaves the last ``w % 8`` columns unwritten, which the port
    zeroes and the JAX package leaves as the heap held them)."""
    monkeypatch.setattr(j_ingest, "read_video", ingest.read_video)
    argv = ["--seconds", "1.0", "--repeats", "2"]
    assert j_host.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    got = profile_host.main([*argv, *CPU])
    assert json.loads(capsys.readouterr().out) == got
    assert _keys(got) == _keys(want)
    for key in ("clip_seconds", "n_frames", "detection_stride",
                "frames_detected_per_rep"):
        assert got[key] == want[key], key
    assert got["n_frames"] == 15
    assert set(got["stage_ms"]) == {"decode_video", "decode_audio", "mel",
                                    "detect", "track", "crop_device"}


@pytest.mark.parametrize("name, key, bf16", [
    ("NVIDIA H100 80GB HBM3", "H100", 989e12),
    ("NVIDIA H100 PCIe", "H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", "H100 NVL", 835e12),
])
def test_card_peaks_are_the_published_ones(name, key, bf16):
    """The profilers' MFU reads the card's published dense peaks; a card
    the table lacks raises, and the CPU has none."""
    from lipsync_tpu_torch.utils.device import card_peaks, device_peaks

    got_key, peaks = card_peaks(name)
    assert got_key == key and peaks.bf16 == bf16
    # int8 twice bf16, TF32 half of it, to the data sheets' rounding
    assert peaks.int8 == pytest.approx(2 * peaks.bf16, rel=2e-3)
    assert peaks.tf32 == pytest.approx(peaks.bf16 / 2, rel=2e-3)
    with pytest.raises(ValueError, match="no published peaks"):
        card_peaks("NVIDIA A100-SXM4-80GB")
    assert device_peaks("cpu") is None
