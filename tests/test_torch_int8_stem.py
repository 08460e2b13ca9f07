"""K3's halo loop (``csrc/int8_conv.cu``, every ``C_in % 32 != 0``
geometry: the two stems) on the CPU, through the wrapper's host half.

The loop stages a tile of ``tr`` output rows x ``tw`` output columns' input
in shared memory, each voxel's channels zero-padded to ``4 * cw`` and read
as ``cw`` 32-bit words, and multiplies GEMM row ``r``'s K words, found at
``halo_row_base(r) + halo_tap_offsets[q]``, with the packed weights
(``pack_halo_weights``). :func:`_halo_model` runs exactly that in numpy,
tile by tile, from the wrapper's own plan, offsets and packed weights, and
must equal the twin ``int8_conv_plain`` and JAX's
``lax.conv_general_dilated(..., preferred_element_type=int32)`` bit for
bit. ``int8_conv`` at a visual-stem geometry stays within 1e-6 relative
of JAX's ``Int8Conv``, with and without bias.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lipsync_tpu.models.layers import Int8Conv
from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
from lipsync_tpu_torch.models import layers as layers_mod
from lipsync_tpu_torch.models.layers import int8_conv
from lipsync_tpu_torch.ops.kernels import int8_conv as k3

torch.set_num_threads(1)

# channels-last x, (C_out, *k, C_in), stride, padding
CONVS = {
    "visual_stem": ((2, 4, 12, 14, 3), (16, 3, 7, 7, 3), (1, 2, 2),
                    (1, 3, 3)),
    "audio_stem": ((2, 20, 16, 1), (8, 7, 7, 1), (2, 2), (3, 3)),
    "c2": ((2, 3, 9, 10, 2), (8, 2, 5, 3, 2), (1, 2, 1), (0, 2, 1)),
    "c5": ((1, 3, 7, 9, 5), (16, 3, 3, 3, 5), (1, 2, 2), (1, 1, 1)),
    "c8_2d": ((2, 11, 9, 8), (24, 3, 3, 8), (2, 1), (1, 1)),
    "stride1_stem": ((1, 3, 10, 11, 3), (8, 3, 7, 7, 3), (1, 1, 1),
                     (1, 3, 3)),
    # ow = 200: a row of output splits into tiles, the last one partial
    "partial_wide": ((1, 1, 4, 400, 2), (8, 1, 3, 3, 2), (1, 1, 2),
                     (0, 1, 1)),
    "partial_rows": ((3, 2, 13, 6, 1), (8, 1, 5, 5, 1), (1, 1, 1),
                     (0, 2, 2)),
}


def _as_3d(x, w, stride, pad):
    if x.ndim == 4:
        return x[:, None], w[:, None], (1, *stride), (0, *pad)
    return x, w, tuple(stride), tuple(pad)


def _halo_model(x, w, stride, pad):
    """The halo loop's GEMM in numpy, tile by tile, from the wrapper's
    plan, tap offsets, row bases and packed weights. Returns int32 (N,
    [Do,] Ho, Wo, C_out) and the plan."""
    nd = x.ndim - 2
    x5, w5, s3, p3 = _as_3d(x, w, stride, pad)
    n, d, h, wd, c = x5.shape
    cout, kd, kh, kw, _ = w5.shape
    od, oh, ow = (k3.out_size(*a) for a in zip((d, h, wd), (kd, kh, kw),
                                               s3, p3))
    plan = k3.halo_plan(x5.shape, w5.shape, s3, p3)
    off = k3.halo_tap_offsets(plan, w5.shape)
    rows = plan.tr * plan.tw
    base = np.array([k3.halo_row_base(plan, s3, r) for r in range(rows)])
    b = k3.pack_halo_weights(torch.from_numpy(w5), plan).numpy()
    b = b.reshape(cout, plan.kblocks * 32, 4).astype(np.int64)
    # Zeros around the input stand for the padding and for every voxel of
    # a halo outside the input; channels padded to 4 * cw.
    m = max(plan.hr, plan.hc, kd) + max(p3)
    xp = np.pad(x5, ((0, 0), (m, m), (m, m), (m, m),
                     (0, 4 * plan.cw - c)))
    out = np.zeros((n, od, oh, ow, cout), np.int64)
    for b_n in range(n):
        for o_d in range(od):
            for oh0 in range(0, oh, plan.tr):
                for ow0 in range(0, ow, plan.tw):
                    id0 = o_d * s3[0] - p3[0] + m
                    ih0 = oh0 * s3[1] - p3[1] + m
                    iw0 = ow0 * s3[2] - p3[2] + m
                    halo = xp[b_n, id0:id0 + kd, ih0:ih0 + plan.hr,
                              iw0:iw0 + plan.hc]
                    assert halo.shape[:3] == (kd, plan.hr, plan.hc)
                    words = halo.reshape(-1, 4)
                    a = words[base[:, None] + off[None, :]].astype(np.int64)
                    acc = np.einsum("rqb,oqb->ro", a, b)
                    for r in range(rows):
                        o_h = oh0 + r // plan.tw
                        o_w = ow0 + r % plan.tw
                        if o_h < oh and o_w < ow:
                            out[b_n, o_d, o_h, o_w] = acc[r]
    out = out.astype(np.int32)
    return (out[:, 0] if nd == 2 else out), plan


def _jax_int32(x, w, stride, pad):
    sp = "DHW"[3 - len(stride):]
    k = np.moveaxis(w, 0, -1)  # (k..., I, O)
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape,
                                        (f"N{sp}C", f"{sp}IO", f"N{sp}C"))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), stride, [(p, p) for p in pad],
        dimension_numbers=dn, preferred_element_type=jnp.int32))


def _operands(name, seed=0):
    x_shape, w_shape, stride, pad = CONVS[name]
    rng = np.random.RandomState(seed + len(name))
    x = rng.randint(-127, 128, x_shape).astype(np.int8)
    w = rng.randint(-127, 128, w_shape).astype(np.int8)
    return x, w, stride, pad


@pytest.mark.parametrize("name", sorted(CONVS))
def test_halo_gemm_equals_twin_and_jax(name):
    x, w, stride, pad = _operands(name)
    assert k3.main_loop(x.shape, w.shape) == "halo"
    got, plan = _halo_model(x, w, stride, pad)
    twin = k3.int8_conv_plain(torch.from_numpy(x), torch.from_numpy(w),
                              stride, pad).numpy()
    want = _jax_int32(x, w, stride, pad)
    assert got.shape == twin.shape == want.shape
    np.testing.assert_array_equal(twin, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CONVS))
def test_halo_reads_stay_inside_the_halo(name):
    """Every word a tile row reads lies in the halo, the packed weights are
    zero in the padded channels and past K, and the plan fits."""
    x, w, stride, pad = _operands(name)
    x5, w5, s3, p3 = _as_3d(x, w, stride, pad)
    plan = k3.halo_plan(x5.shape, w5.shape, s3, p3)
    kd, c = w5.shape[1], w5.shape[-1]
    off = k3.halo_tap_offsets(plan, w5.shape)
    assert off.shape == (plan.kblocks * 32,) and off.dtype == np.int32
    last = max(k3.halo_row_base(plan, s3, r)
               for r in range(plan.tr * plan.tw))
    assert 0 <= off.min() and last + off.max() < kd * plan.hr * plan.hc * \
        plan.cw
    assert plan.tr * plan.tw <= max(k3.HALO_ROWS)
    assert plan.smem <= k3.SMEM_LIMIT
    b = k3.pack_halo_weights(torch.from_numpy(w5), plan).numpy()
    assert b.shape == (w.shape[0], 128 * plan.kblocks)
    words = b[:, :4 * plan.kwords].reshape(w.shape[0], -1, 4 * plan.cw)
    assert not words[..., c:].any()
    assert not b[:, 4 * plan.kwords:].any()
    np.testing.assert_array_equal(words[..., :c],
                                  w5.reshape(w.shape[0], -1, c))


def test_model_stems_plan():
    """The two stems of ``ModelConfig()`` at B = 16: the visual one in
    tiles of 4 rows x 48 (192 GEMM rows), the audio one 2 x 64 (128), one
    word per tap; K 147 and 49 words."""
    cfg = ModelConfig()
    visual = k3.halo_plan((16, cfg.video_frames, cfg.crop_size,
                           cfg.crop_size, 3), (64, 3, 7, 7, 3), (1, 2, 2),
                          (1, 3, 3))
    audio = k3.halo_plan((16, 1, cfg.mel_bins, cfg.audio_frames, 1),
                         (64, 1, 7, 7, 1), (1, 2, 2), (0, 3, 3))
    assert (visual.cw, visual.kwords, visual.tr, visual.tw) == (1, 147, 4, 48)
    assert (visual.hr, visual.hc, visual.kblocks) == (13, 101, 5)
    assert (audio.cw, audio.kwords, audio.tr, audio.tw) == (1, 49, 2, 64)
    # Two visual blocks fit on one SM.
    assert 2 * visual.smem <= 233472


@pytest.mark.parametrize("bias", [False, True])
def test_int8_conv_visual_stem_matches_jax_int8conv(bias):
    """``int8_conv`` at a (3, 7, 7) C_in = 3 visual stem, within the
    1e-6 relative of ``test_torch_int8_fused.py``."""
    x_shape, w_shape, stride, pad = CONVS["visual_stem"]
    rng = np.random.RandomState(23)
    x = rng.randn(*x_shape).astype(np.float32)
    w = (rng.randn(*w_shape) * 0.1).astype(np.float32)  # (O, k..., I)
    b = rng.randn(w_shape[0]).astype(np.float32) if bias else None
    params = {"kernel": np.moveaxis(w, 0, -1)}
    if bias:
        params["bias"] = b
    want = np.asarray(Int8Conv(
        w_shape[0], w_shape[1:-1], stride, [(p, p) for p in pad],
        use_bias=bias).apply({"params": params}, jnp.asarray(x)))
    got = int8_conv(torch.from_numpy(x).movedim(-1, 1),
                    torch.from_numpy(w).movedim(-1, 1),
                    None if b is None else torch.from_numpy(b), stride,
                    pad).movedim(1, -1).numpy()
    assert k3.main_loop(x_shape, w_shape) == "halo"
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-6, rel


def test_every_stem_of_the_model_takes_the_halo_loop():
    cfg = dataclasses.replace(ModelConfig(), conv_lowering="int8")
    stems = [m[0] for m in LipSyncModel(cfg).modules()
             if isinstance(m, layers_mod.ConvBNAct) and m.lowering == "int8"
             and m[0].in_channels % 32]
    assert sorted(c.in_channels for c in stems) == [1, 3]
    for conv in stems:
        w = conv.weight.movedim(1, -1)
        assert k3.main_loop((1, *[8] * (w.dim() - 2), w.shape[-1]),
                            w.shape) == "halo"
