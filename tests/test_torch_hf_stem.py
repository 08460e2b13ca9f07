"""K2's plain twin and the port's HighFrequencyDetector against JAX (CPU).

The twin is held against ``hf_stem_fused(..., interpret=True)`` at the
geometry of the JAX package's own kernel test (B2, T4, H16) with atol 2e-5;
the eval-mode detector (which calls the K2 wrapper) against JAX's with
atol 1e-4. The CUDA kernel is held against the twin on the card by
tests/test_torch_kernels_card.py.
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


def _im2col_gemm(video, lap_weight, conv_weight, *bn, eps=1e-5):
    """The kernel's arithmetic in plain torch (float64): the twin's
    Laplacian, split as the kernel splits it (a_hi, a_lo), times conv1
    rebuilt from the packed fragments of ``k2.pack_w1`` as the kernel reads
    them (lane ``4*g + tig`` of k-step ``ks``, column tile ``nt``), summed
    a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, then scale, shift and ReLU."""
    b, t, h, w, _ = video.shape
    frames = video.float().reshape(b * t, h, w, 3).permute(0, 3, 1, 2)
    lap = torch.nn.functional.conv2d(frames, lap_weight.float(), padding=1)
    lap = lap.reshape(b, t, 3, h, w)
    lap = torch.nn.functional.pad(lap, (1, 1, 1, 1, 0, 0, 1, 1))
    ho, wo = k2.out_size(h), k2.out_size(w)
    cols = torch.zeros(b, t, ho, wo, 96)
    for dt in range(3):
        for dx in range(3):
            for dy in range(3):
                for ci in range(3):
                    k = dt * 32 + (dx * 3 + dy) * 3 + ci
                    cols[..., k] = lap[:, dt:dt + t, ci,
                                       dy:dy + 2 * ho:2, dx:dx + 2 * wo:2]
    frag = k2.pack_w1(conv_weight).reshape(k2.K_STEPS, 4, 8, 4, 4)
    b_hi = torch.zeros(96, 32, dtype=torch.float64)
    b_lo = torch.zeros(96, 32, dtype=torch.float64)
    for ks in range(k2.K_STEPS):
        for nt in range(4):
            for g in range(8):
                for tig in range(4):
                    k0, n = 8 * ks + tig, 8 * nt + g
                    q = frag[ks, nt, g, tig].double()
                    b_hi[k0, n], b_hi[k0 + 4, n] = q[0], q[1]
                    b_lo[k0, n], b_lo[k0 + 4, n] = q[2], q[3]
    a_hi = k2.tf32_round(cols)
    a_lo = k2.tf32_round(cols - a_hi)
    y = (a_lo.double() @ b_hi + a_hi.double() @ b_lo
         + a_hi.double() @ b_hi)
    scale, shift = k2.fold_bn(*bn, eps)
    return torch.relu(y * scale.double() + shift.double())


def _chain_f64(video, lap_weight, conv_weight, conv_bias, bn_weight, bn_bias,
               bn_mean, bn_var, eps=1e-5):
    """The twin's chain (Laplacian, conv1, BN, ReLU) in float64."""
    b, t, h, w, _ = video.shape
    frames = video.double().reshape(b * t, h, w, 3).permute(0, 3, 1, 2)
    lap = torch.nn.functional.conv2d(frames, lap_weight.double(), padding=1)
    x = lap.reshape(b, t, 3, h, w).transpose(1, 2)
    y = torch.nn.functional.conv3d(x, conv_weight.double(),
                                   conv_bias.double(), stride=(1, 2, 2),
                                   padding=1)
    y = torch.nn.functional.batch_norm(
        y, bn_mean.double(), bn_var.double(), bn_weight.double(),
        bn_bias.double(), False, 0.0, eps)
    return torch.relu(y).permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("shape", [(2, 4, 16, 16), (2, 4, 15, 10)])
def test_packed_w1_im2col_gemm_matches_twin(shape):
    """conv1 as the kernel packs it (TF32 hi/lo in mma fragment order, K
    padded to 3 x 32) and sums it (3xTF32) reproduces the twin's chain to
    1e-6 (held against that chain in float64: at outputs up to ~5 the fp32
    twin itself is ~1.5e-6 from it) and the twin within the kernel's fp32
    atol 2e-5; stored in bf16 it stays within the bf16 tolerance
    |d| <= 8e-3 |fp32| + 1e-5 of the twin on the same bf16 input."""
    p = _stem_inputs(np.random.RandomState(5), *shape)
    args = _port_args(p)
    want = k2.hf_stem_plain(*args).double()
    got = _im2col_gemm(*args)
    exact = _chain_f64(*args)
    print(f"max |delta| packed GEMM {shape}: vs float64 chain "
          f"{(got - exact).abs().max():.3g}, vs twin "
          f"{(got - want).abs().max():.3g} (twin vs float64 "
          f"{(want - exact).abs().max():.3g})")
    torch.testing.assert_close(got, exact, atol=1e-6, rtol=0)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    v16 = args[0].to(torch.bfloat16)
    want16 = k2.hf_stem_plain(v16.float(), *args[1:]).double()
    got16 = _im2col_gemm(v16, *args[1:]).to(torch.bfloat16).double()
    used = ((got16 - want16).abs() / (8e-3 * want16.abs() + 1e-5)).max()
    print(f"bf16 tolerance used {shape}: {float(used):.3g}")
    assert used <= 1.0


def test_pack_w1_matches_the_kernel_prologue_order():
    """The kernel's prologue packs conv1 from the raw OITHW weight: float4
    ``i`` (``ks = i >> 7``, ``nt = (i >> 5) & 3``, ``lane = i & 31``) holds
    the TF32 hi and lo parts of rows ``k0 = 8*ks + lane % 4`` and ``k0 + 4``
    at column ``8*nt + lane // 4``; row ``k`` is tap ``(dx, dy, ci)`` of
    frame ``k // 32`` for ``k % 32 < 27``, else zero. ``pack_w1``, its CPU
    reference, gives the same floats."""
    w = np.random.RandomState(6).randn(32, 3, 3, 3, 3).astype(np.float32)

    def w1_at(k, n):
        dt, kk = divmod(k, 32)
        if kk >= 27:
            return np.float32(0.0)
        dx, dy, ci = kk // 9, kk // 3 % 3, kk % 3
        return w[n, ci, dt, dy, dx]

    quads = []
    for i in range(k2.K_STEPS * 4 * 32):
        ks, nt, lane = i >> 7, (i >> 5) & 3, i & 31
        k0, n = 8 * ks + (lane & 3), 8 * nt + (lane >> 2)
        v = torch.tensor([w1_at(k0, n), w1_at(k0 + 4, n)])
        hi = k2.tf32_round(v)
        lo = k2.tf32_round(v - hi)
        quads.append(torch.stack([hi[0], hi[1], lo[0], lo[1]]))
    assert torch.equal(k2.pack_w1(torch.from_numpy(w)),
                       torch.stack(quads).reshape(-1))


def test_tf32_round_keeps_ten_mantissa_bits_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11,
                      -(1 + 2.0 ** -11), 3.14159265, 1e-20])
    r = k2.tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert r[0] == 1.0
    assert r[1] == 1 + 2.0 ** -10           # tie rounds away from zero
    assert r[2] == 1 + 2.0 ** -9
    assert r[3] == -(1 + 2.0 ** -10)
    assert (r - x).abs().le(x.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("b,run", [(1, 2), (16, 11), (128, 16)])
def test_run_length_fills_the_card_at_main_path_batches(b, run):
    """B = 1 / 16 / 128 windows of 32 frames at 96 x 96 on 132 SMs (two
    blocks each): every SM gets a block, and the run keeps the last wave
    of blocks from running nearly alone (at B=16 whole-clip halves would
    give 288 blocks for 264 places: two waves of 16 frames, against two of
    11 here)."""
    got = k2.run_length(b, 32, 96, 96, 132)
    assert got == run
    blocks = b * 9 * -(-32 // got)
    assert blocks >= 132
    waves = -(-blocks // 264)
    assert waves * (got + 1.5) <= -(-b * 9 * 2 // 264) * 17.5
