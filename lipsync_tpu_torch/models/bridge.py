"""Weights between the JAX package's variables and the port's state dicts.

The port's modules carry the reference checkpoint's parameter names, so a
reference ``.pth`` loads with ``load_state_dict(strict=True)`` and a port
``state_dict()`` converts with the JAX package's converter unchanged.
:func:`variables_to_state_dict` is that converter's inverse: JAX
``{"params", "batch_stats"}`` trees (numpy or any array type that
``np.asarray`` reads) -> port ``state_dict``. Layout rules, inverted:

  Conv3d (kT,kH,kW,I,O) -> (O,I,kT,kH,kW)
  Conv2d (kH,kW,I,O)    -> (O,I,kH,kW)
  Conv1d (k,I,O)        -> (O,I,k)
  Linear (I,O)          -> (O,I)
  q/k/v (D,D) each      -> packed in_proj_weight (3D,D), in_proj_bias (3D,)
  BatchNorm scale/bias  -> weight/bias; batch_stats mean/var -> running_*

:func:`seeded_state_dict` makes numpy weights for a port module from a
seed, with non-trivial BatchNorm statistics (mean != 0, var != 1).
:func:`bn_calibrated_state_dict` replaces those statistics with the ones a
batch of inputs produces, so that the seeded model's activations stay near
unit scale and its logits vary from input to input.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel, ModelConfig

Tree = Mapping[str, Any]
Path = Tuple[str, ...]


def unwrap_state_dict(ckpt: Mapping[str, Any]) -> Mapping[str, Any]:
    """Accept raw state dicts or ``model_state_dict``/``state_dict``
    checkpoint wrappers."""
    for key in ("model_state_dict", "state_dict"):
        if key in ckpt:
            return ckpt[key]
    return ckpt


class _Emitter:
    def __init__(self, variables: Tree):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: Dict[str, torch.Tensor] = {}

    @staticmethod
    def _node(tree: Tree, path: Path):
        for p in path:
            tree = tree[p]
        return tree

    def has(self, path: Path) -> bool:
        try:
            self._node(self.params, path)
        except KeyError:
            return False
        return True

    def _get(self, tree: Tree, path: Path) -> np.ndarray:
        return np.asarray(self._node(tree, path), np.float32)

    def _put(self, key: str, value: np.ndarray) -> None:
        self.sd[key] = torch.from_numpy(np.array(value, np.float32))

    # --- primitive emitters ----------------------------------------------
    def conv(self, tkey: str, path: Path) -> None:
        k = self._get(self.params, path + ("kernel",))
        nd = k.ndim
        self._put(tkey + ".weight",
                  np.transpose(k, (nd - 1, nd - 2) + tuple(range(nd - 2))))
        if self.has(path + ("bias",)):
            self._put(tkey + ".bias", self._get(self.params, path + ("bias",)))

    def bn(self, tkey: str, path: Path) -> None:
        self._put(tkey + ".weight", self._get(self.params, path + ("scale",)))
        self._put(tkey + ".bias", self._get(self.params, path + ("bias",)))
        self._put(tkey + ".running_mean",
                  self._get(self.stats, path + ("mean",)))
        self._put(tkey + ".running_var", self._get(self.stats, path + ("var",)))
        self.sd[tkey + ".num_batches_tracked"] = torch.tensor(0)

    def linear(self, tkey: str, path: Path) -> None:
        self._put(tkey + ".weight",
                  self._get(self.params, path + ("kernel",)).T)
        if self.has(path + ("bias",)):
            self._put(tkey + ".bias", self._get(self.params, path + ("bias",)))

    def layernorm(self, tkey: str, path: Path) -> None:
        self._put(tkey + ".weight", self._get(self.params, path + ("scale",)))
        self._put(tkey + ".bias", self._get(self.params, path + ("bias",)))

    def mha(self, tkey: str, path: Path) -> None:
        names = ("q_proj", "k_proj", "v_proj")
        self._put(tkey + ".in_proj_weight", np.concatenate(
            [self._get(self.params, path + (n, "kernel")).T for n in names]))
        self._put(tkey + ".in_proj_bias", np.concatenate(
            [self._get(self.params, path + (n, "bias")) for n in names]))
        self.linear(tkey + ".out_proj", path + ("out_proj",))

    # --- composite emitters ----------------------------------------------
    def conv_bn(self, tconv: str, tbn: str, path: Path) -> None:
        self.conv(tconv, path + ("conv",))
        self.bn(tbn, path + ("bn",))

    def residual_block(self, tkey: str, path: Path) -> None:
        for name in ("conv1", "conv2", "downsample"):
            if self.has(path + (name,)):
                self.conv_bn(f"{tkey}.{name}.0", f"{tkey}.{name}.1",
                             path + (name,))

    def encoder(self, tkey: str, path: Path) -> None:
        self.conv_bn(tkey + ".stem.0", tkey + ".stem.1", path + ("stem",))
        for i in range(1, 5):
            self.residual_block(f"{tkey}.layer{i}", path + (f"layer{i}",))


def variables_to_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` -> port ``state_dict`` (fp32 CPU
    tensors). The temporal depth and the optional branches are read from
    the tree."""
    e = _Emitter(variables)
    e.encoder("visual_encoder", ("visual_encoder",))
    e.encoder("audio_encoder", ("audio_encoder",))
    e.linear("projection.visual_proj", ("projection", "visual_proj"))
    e.linear("projection.audio_proj", ("projection", "audio_proj"))

    cm = ("cross_modal",)
    e.mha("cross_modal.v2a_attn", cm + ("v2a_attn",))
    e.mha("cross_modal.a2v_attn", cm + ("a2v_attn",))
    e.linear("cross_modal.gate.0", cm + ("gate_fc1",))
    e.linear("cross_modal.gate.2", cm + ("gate_fc2",))
    e.linear("cross_modal.fuse.0", cm + ("fuse_fc",))

    tp = ("temporal",)
    e._put("temporal.cls_token", e._get(e.params, tp + ("cls_token",)))
    if e.has(tp + ("branch_k3_conv",)):
        for k in (3, 5, 7):
            e.conv(f"temporal.branch_k{k}.0", tp + (f"branch_k{k}_conv",))
            e.bn(f"temporal.branch_k{k}.1", tp + (f"branch_k{k}_bn",))
        e.linear("temporal.pre_scale_proj", tp + ("pre_scale_proj",))
    i = 0
    while e.has(tp + (f"layer_{i}",)):
        tkey, path = f"temporal.transformer.layers.{i}", tp + (f"layer_{i}",)
        e.mha(tkey + ".self_attn", path + ("self_attn",))
        e.linear(tkey + ".linear1", path + ("linear1",))
        e.linear(tkey + ".linear2", path + ("linear2",))
        e.layernorm(tkey + ".norm1", path + ("norm1",))
        e.layernorm(tkey + ".norm2", path + ("norm2",))
        i += 1

    ad = ("artifact_detector",)
    if e.has(ad):
        td, tk = ad + ("temporal_detector",), "artifact_detector.temporal_detector"
        e.conv_bn(f"{tk}.temporal_conv.0", f"{tk}.temporal_conv.1",
                  td + ("conv1",))
        e.conv_bn(f"{tk}.temporal_conv.3", f"{tk}.temporal_conv.4",
                  td + ("conv2",))
        hf, hk = ad + ("high_freq_detector",), "artifact_detector.high_freq_detector"
        if e.has(hf):
            e.conv(f"{hk}.laplacian", hf + ("laplacian",))
            e.conv_bn(f"{hk}.conv3d.0", f"{hk}.conv3d.1", hf + ("conv1",))
            e.conv_bn(f"{hk}.conv3d.3", f"{hk}.conv3d.4", hf + ("conv2",))
        e.linear("artifact_detector.artifact_fusion.0", ad + ("fusion_fc1",))
        e.linear("artifact_detector.artifact_fusion.2", ad + ("fusion_fc2",))

    e.linear("classifier.net.0", ("classifier", "fc1"))
    e.layernorm("classifier.net.3", ("classifier", "norm"))
    e.linear("classifier.net.4", ("classifier", "fc2"))
    return e.sd


def seeded_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Numpy-made weights for every entry of ``model.state_dict()``:
    fan-in-scaled normal conv/linear weights, small biases, BatchNorm scales
    in [0.5, 1.5] with running means ~N(0, 0.1) and variances in [0.5, 1.5],
    LayerNorm scales in [0.8, 1.2], and the Laplacian's init plus noise so
    its 3->3 channel mix is non-trivial."""
    rng = np.random.default_rng(seed)
    norm_prefixes = {
        name: isinstance(m, nn.LayerNorm)
        for name, m in model.named_modules()
        if isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm))
    }
    out: Dict[str, torch.Tensor] = {}
    for key, ref in model.state_dict().items():
        prefix, _, leaf = key.rpartition(".")
        shape = tuple(ref.shape)
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros_like(ref)
            continue
        if prefix in norm_prefixes:
            is_ln = norm_prefixes[prefix]
            if leaf == "weight":
                lo, hi = (0.8, 1.2) if is_ln else (0.5, 1.5)
                v = rng.uniform(lo, hi, shape)
            elif leaf == "running_var":
                v = rng.uniform(0.5, 1.5, shape)
            else:  # bias, running_mean
                v = rng.normal(0.0, 0.1, shape)
        elif leaf == "cls_token":
            v = rng.normal(0.0, 0.02, shape)
        elif leaf.endswith("bias"):
            v = rng.normal(0.0, 0.05, shape)
        else:  # conv / linear / packed attention weights
            fan_in = int(np.prod(shape[1:]))
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
            if prefix.endswith("laplacian"):
                v = ref.detach().cpu().numpy() + 0.1 * v
        out[key] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def bn_calibrated_state_dict(
    config: ModelConfig,
    state_dict: Mapping[str, torch.Tensor],
    visual: torch.Tensor,
    audio: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every BatchNorm's running mean and variance set
    to the statistics of one training-mode forward over ``visual`` /
    ``audio`` (fp32, dropout off), on their device. In eval mode each
    BatchNorm then normalises what it sees on such inputs."""
    model = LipSyncModel(dataclasses.replace(config, dropout=0.0))
    model.load_state_dict(state_dict, strict=True)
    model.to(visual.device)
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_running_stats()
            m.momentum = None  # cumulative: one batch gives its statistics
    model.train()
    with torch.no_grad():
        model(visual.float(), audio.float())
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
