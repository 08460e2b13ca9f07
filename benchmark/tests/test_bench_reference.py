"""The plain reference held to the program at the small geometry of the
repository's CPU tests (full widths, 8 frames of 48x48, 32 mel frames).

These tests import the program to compare with it; the reference itself
imports nothing of it (``test_bench_rehearsal.py``)."""

import dataclasses

import pytest
import torch

from benchmark.core import flops
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

SMALL = {"video_frames": 8, "crop_size": 48, "mel_bins": 80,
         "audio_frames": 32}
PLACEMENT = {
    "visual_low": {"act": "fp32", "math": "fp32"},
    "visual_high": {"act": "bf16", "math": "bf16"},
    "audio": {"act": "fp32", "math": "fp32"},
    "artifact": {"act": "bf16", "math": "bf16"},
    "tokens": {"act": "fp32", "math": "fp32"},
}
INT8 = dict(PLACEMENT, visual_low={"act": "fp32", "math": "int8"},
            visual_high={"act": "bf16", "math": "int8"},
            audio={"act": "fp32", "math": "int8"})


def _port(dtype=torch.float32, **kw):
    from lipsync_tpu_torch.models import LipSyncModel, ModelConfig

    return LipSyncModel(ModelConfig(**SMALL, **kw), dtype=dtype)


@pytest.fixture(scope="module")
def inputs():
    g = torch.Generator().manual_seed(0)
    v = torch.randint(0, 256, (4, 8, 48, 48, 3), generator=g,
                      dtype=torch.uint8)
    a = -80 * torch.rand(4, 80, 32, 1, generator=g)
    w = ref.make_weights(SMALL, 123, "cpu")
    ref.calibrate(w, SMALL, v.float() / 255, a)
    return w, v, a


def test_param_table_is_the_programs():
    sd = _port().state_dict()
    shapes = ref.param_shapes(SMALL)
    assert set(shapes) == set(sd)
    assert all(tuple(sd[k].shape) == shapes[k] for k in sd)


def test_weights_follow_the_seed():
    a, b = ref.make_weights(SMALL, 7, "cpu"), ref.make_weights(SMALL, 7, "cpu")
    c = ref.make_weights(SMALL, 8, "cpu")
    k = "visual_encoder.stem.0.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert float(a["visual_encoder.stem.1.running_var"].min()) == 1.0


def test_calibration_spreads_the_logits(inputs):
    w, v, a = inputs
    logits = ref.logits_in_blocks(w, SMALL, v, a, ref.fp32_precision(), 4)
    assert float(logits.std()) > 0.1
    assert float(w["visual_encoder.stem.1.running_var"].min()) != 1.0


def _eval(model, w, v, a):
    model.load_state_dict(w, strict=True)
    model.eval()
    with torch.no_grad():
        return model(v.float() / 255, a)


def test_fp32_forward_is_the_programs(inputs):
    w, v, a = inputs
    got = _eval(_port(), w, v, a)
    want = ref.logits_in_blocks(w, SMALL, v, a, ref.fp32_precision(), 4)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("name, precision, kw, bound", [
    ("bf16 placement", PLACEMENT, {}, 5e-3),
    ("int8 encoders", INT8, {"conv_lowering": "int8"}, 2e-3),
])
def test_stated_precision_follows_the_program(inputs, name, precision, kw,
                                              bound):
    w, v, a = inputs
    got = _eval(_port(torch.bfloat16, **kw), w, v, a)
    want = ref.logits_in_blocks(w, SMALL, v, a, precision, 4)
    gap = float((got - want).abs().max())
    control = ref.logits_in_blocks(w, SMALL, v, a, ref.lower(precision), 4)
    assert gap <= bound, name
    assert float((control - want).abs().max()) > 3 * gap, name


def test_lower_steps_each_part_down():
    low = ref.lower(INT8)
    assert low["visual_low"]["math"] == "int4"
    assert low["artifact"] == {"act": "bf16", "math": "int8"}
    assert low["tokens"]["math"] == "tf32"


def test_rounding():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, -3.0])
    assert torch.equal(ref.round_tf32(x), torch.tensor([1.0, 1.0 + 2 ** -10,
                                                        -3.0]))
    assert float(ref.round_bf16(torch.tensor(1.0 + 2 ** -9))) == 1.0


def test_train_step_is_the_programs(inputs):
    from lipsync_tpu_torch.ops.augment import AugmentConfig
    from lipsync_tpu_torch.training.optimizers import PhaseOptimizer
    from lipsync_tpu_torch.training.steps import (
        create_train_state,
        make_train_step,
    )

    w, _, _ = inputs
    model = _port()
    model.load_state_dict(w)
    opt = PhaseOptimizer(model.named_parameters(), 3, lr_head=1e-4,
                         lr_encoder=1e-4)
    state = create_train_state(model, opt, seed=77)
    step = make_train_step(augment_cfg=AugmentConfig())
    g = torch.Generator().manual_seed(1)
    batches = [{
        "visual": torch.randint(0, 256, (4, 8, 48, 48, 3), generator=g,
                                dtype=torch.uint8),
        "audio": -80 * torch.rand(4, 80, 32, 1, generator=g),
        "label": torch.tensor([1.0, 0.0, 1.0, 0.0]),
        "sample_mask": torch.ones(4)} for _ in range(2)]
    torch.manual_seed(99)
    losses = [float(step(state, b)["loss"]) for b in batches]
    params = {k: v.clone() for k, v in w.items()}
    adam = ref_train.Adam(ref_train.trainable(params), 1e-4)
    aug = torch.Generator().manual_seed(77)
    shift = torch.Generator().manual_seed(77)
    torch.manual_seed(99)
    want = [ref_train.train_step(params, SMALL, b, adam, aug, shift,
                                 ref.fp32_precision(), 0.1)[0]
            for b in batches]
    assert losses[0] == pytest.approx(want[0], rel=1e-6)
    assert losses[1] == pytest.approx(want[1], rel=1e-5)
    got = dict(model.named_parameters())
    for k in ("visual_encoder.stem.0.weight", "classifier.net.4.weight"):
        moved = (params[k] - w[k]).norm()
        assert float((got[k].detach() - params[k]).norm()) <= 1e-3 * float(
            moved)


def test_flops_of_a_window_and_a_step():
    full = {}
    assert flops.forward_flops(full, 1) == pytest.approx(31.2885e9, rel=1e-4)
    assert flops.forward_flops(full, 2) == pytest.approx(
        2 * flops.forward_flops(full, 1), rel=1e-9)
    step = flops.train_step_flops(full, 32)
    assert 3.5e12 < step < 4.5e12


def test_reference_refuses_what_it_does_not_follow():
    for key in ("detect_artifacts", "use_delta_artifact"):
        with pytest.raises(ValueError):
            ref.param_shapes(dict(SMALL, **{key: False}))
    assert dataclasses.is_dataclass(_port().config)
