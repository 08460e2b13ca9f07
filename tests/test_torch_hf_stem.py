"""K2's plain twin and the port's HighFrequencyDetector against JAX (CPU).

The twin is held against ``hf_stem_fused(..., interpret=True)`` at the
geometry of the JAX package's own kernel test (B2, T4, H16) with atol 2e-5;
the eval-mode detector (which calls the K2 wrapper) against JAX's with
atol 1e-4. The CUDA kernel is held against the twin on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lipsync_tpu.models.artifact import HighFrequencyDetector as JHF
from lipsync_tpu.ops.pallas.hf_stem import hf_stem_fused
from lipsync_tpu_torch.ops.kernels import hf_stem as k2
from tests.torch_parity import jax_apply, port_apply, seeded_pair, subtree

torch.set_num_threads(1)


def _stem_inputs(rng, b=2, t=4, h=16, w=16):
    return dict(
        v=rng.rand(b, t, h, w, 3).astype(np.float32),
        wlap=(rng.randn(3, 3, 3, 3) * 0.5).astype(np.float32),  # HWIO
        w1=(rng.randn(3, 3, 3, 3, 32) * 0.1).astype(np.float32),  # THWIO
        b1=(rng.randn(32) * 0.1).astype(np.float32),
        g=(rng.rand(32) + 0.5).astype(np.float32),
        bb=(rng.randn(32) * 0.1).astype(np.float32),
        mu=(rng.randn(32) * 0.1).astype(np.float32),
        var=(rng.rand(32) + 0.5).astype(np.float32),
    )


def _port_args(p):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (
        t(p["v"]), t(p["wlap"].transpose(3, 2, 0, 1)),      # OIHW
        t(p["w1"].transpose(4, 3, 0, 1, 2)),                # OITHW
        t(p["b1"]), t(p["g"]), t(p["bb"]), t(p["mu"]), t(p["var"]),
    )


def test_twin_matches_pallas_interpret():
    p = _stem_inputs(np.random.RandomState(0))
    before = k2.launches
    got = k2.hf_stem(*_port_args(p)).numpy()
    want = np.asarray(hf_stem_fused(
        *(jnp.asarray(p[k]) for k in
          ("v", "wlap", "w1", "b1", "g", "bb", "mu", "var")),
        interpret=True,
    ))
    assert got.shape == want.shape == (2, 4, 8, 8, 32)
    print(f"max |delta| K2 twin vs pallas: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert k2.launches == before  # the CPU twin is no launch


@pytest.mark.parametrize("hw", [(15, 15), (16, 10)])
def test_twin_handles_odd_and_non_square_frames(hw):
    """Ho = (H-1)//2 + 1 on each axis, as for a k3/s2/p1 conv."""
    p = _stem_inputs(np.random.RandomState(1), b=1, t=3, h=hw[0], w=hw[1])
    out = k2.hf_stem(*_port_args(p))
    assert out.shape == (1, 3, k2.out_size(hw[0]), k2.out_size(hw[1]), 32)


def test_twin_keeps_bf16_dtype_and_tracks_fp32():
    p = _stem_inputs(np.random.RandomState(2))
    args = _port_args(p)
    x16 = args[0].to(torch.bfloat16)
    out16 = k2.hf_stem(x16, *args[1:])
    out32 = k2.hf_stem(x16.float(), *args[1:])
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(out16.float(), out32, rtol=8e-3, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = _stem_inputs(np.random.RandomState(3))
    args = _port_args(p)
    with pytest.raises(ValueError):
        k2.hf_stem(args[0][..., :2], *args[1:])
    with pytest.raises(ValueError):
        k2.hf_stem(args[0], args[1][:2], *args[2:])


def test_high_frequency_detector_eval_matches_jax():
    model, _, variables, _ = seeded_pair(2)
    rng = np.random.RandomState(4)
    raw = rng.rand(2, 8, 32, 32, 3).astype(np.float32)
    got = port_apply(model.artifact_detector.high_freq_detector, raw)
    want = jax_apply(
        JHF(64), subtree(variables, "artifact_detector", "high_freq_detector"),
        raw,
    )
    assert got.shape == want.shape == (2, 64)
    print(f"max |delta| HighFrequencyDetector: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_high_frequency_detector_train_mode_runs_modules():
    """Training mode (batch-statistics BN) is a different function: it runs
    the plain modules, not the eval-mode stem."""
    model, *_ = seeded_pair(2)
    hf = model.artifact_detector.high_freq_detector
    raw = torch.rand(2, 4, 16, 16, 3)
    hf.train()
    try:
        with torch.no_grad():
            train_out = hf(raw)
    finally:
        hf.eval()
    with torch.no_grad():
        eval_out = hf(raw)
    assert train_out.shape == eval_out.shape == (2, 64)
    assert not torch.allclose(train_out, eval_out)
