"""The port does all that the JAX package does: every public top-level
``def``/``class`` of every module of ``lipsync_tpu/``, and every public
method of a public class, has a counterpart of the same name in the port's
module of the same path, or stands in the table below as a rename or as
needing no port, with its reason (ROADMAP.md gives the same reasons).

The counterpart takes the same parameters: names, order and defaults (a
class's are its ``__init__``'s, or its fields where it has none, as a flax
module or a dataclass does), apart from the differences of idiom in
``IDIOMS``, each with its reason. The scripts' command-line flags and
defaults are held against the tools' the same way (``FLAG_IDIOMS``).

The walk reads both packages with ``ast``; it imports neither.
"""

import ast
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "lipsync_tpu"
PORT_PKG = ROOT / "lipsync_tpu_torch"

# (JAX module, JAX name) -> (port module, port name): the same function
# under another name or path.
RENAMES = {
    ("ops/pallas/mel_kernel.py", "log_mel_spectrogram_pallas"):
        ("ops/kernels/mel.py", "log_mel_spectrogram_fused"),  # K1, CUDA
    ("ops/pallas/hf_stem.py", "hf_stem_fused"):
        ("ops/kernels/hf_stem.py", "hf_stem"),  # K2, CUDA
    ("utils/profiling.py", "tpu_trace"):
        ("utils/profiling.py", "cuda_trace"),  # torch.profiler, not jax's
    ("utils/device.py", "get_platform"):
        ("utils/device.py", "get_device"),  # a torch device, never a silent CPU
    ("models/layers.py", "Int8Conv"):
        ("models/layers.py", "int8_conv"),  # the lowering on K4 and K3
    ("training/optimizers.py", "make_phase_optimizer"):
        ("training/optimizers.py", "PhaseOptimizer"),  # torch param groups
    ("models/lip_sync_model.py", "LipSyncModel.setup"):
        ("models/lip_sync_model.py", "LipSyncModel.__init__"),  # flax setup
}

# (JAX module, JAX name) -> why the port has no counterpart.
NEEDS_NO_PORT = {
    ("models/convert.py", "torch_state_dict_to_variables"):
        "the port loads reference .pth files by name; models/bridge.py is "
        "its inverse",
    ("models/convert.py", "load_torch_checkpoint"):
        "the port loads reference .pth files by name; models/bridge.py is "
        "its inverse",
    ("models/layers.py", "ShiftMatmulConv"):
        "a plain Conv3d computes the same function",
    ("ops/image.py", "resize_bilinear"):
        "only a test of the JAX package calls it",
    ("parallel/mesh.py", "batch_sharding"):
        "pjit sharding; the port has shard_rows, Lockstep and run_group",
    ("parallel/mesh.py", "replicated"):
        "pjit sharding; the port has shard_rows, Lockstep and run_group",
    ("parallel/mesh.py", "shard_batch"):
        "pjit sharding; the port has shard_rows, Lockstep and run_group",
    ("parallel/mesh.py", "replicate"):
        "pjit sharding; the port has shard_rows, Lockstep and run_group",
    ("utils/device.py", "enable_persistent_compilation_cache"):
        "JAX's compilation cache; it needs JAX",
    ("training/optimizers.py", "map_learning_rates"):
        "walks optax state; PhaseOptimizer's parameter groups hold the rates",
    ("serving/schemas.py", "EvaluationItem"):
        "no code in the JAX package reads it",
    ("serving/schemas.py", "BatchEvaluateRequest"):
        "no code in the JAX package reads it",
    ("serving/schemas.py", "JobStatusResponse"):
        "no code in the JAX package reads it",
}


class Idiom(NamedTuple):
    """A difference of idiom between a JAX signature and the port's: JAX
    parameters the port has no use for (``drop``), parameters only the port
    takes (``add``), JAX names the port spells otherwise (``rename``, pairs)
    and defaults that the idiom changes (``defaults``, pairs of port name
    and default source)."""

    reason: str
    drop: Tuple[str, ...] = ()
    add: Tuple[str, ...] = ()
    rename: Tuple[Tuple[str, str], ...] = ()
    defaults: Tuple[Tuple[str, str], ...] = ()


DEVICE = ("the port's entry points take the torch device they run on: "
          "cuda:0 unless the caller asks for the CPU (utils/device.py)")
FLAX_DTYPE = ("a flax module's dtype field; a torch module takes its dtype "
              "from .to() or from the model that builds it")
FLAX_FIELDS = ("flax module fields become the torch module's constructor "
               "arguments, with the input widths that flax infers and "
               "PyTorch's names (features -> out_channels, strides -> "
               "stride, use_bias -> bias, act a switch for ReLU)")
TRAIN = ("flax's train= argument is the torch module's mode (model.train() "
         "/ model.eval())")
TORCH_STATE = ("JAX's explicit variables, state, opt_state, params and rng "
               "become torch state: the module's parameters and state dict, "
               "the optimizer object and torch.Generator seeds")
TORCH_DTYPE = "jnp.float32 -> torch.float32"
ARCHITECTURE = ("the port's second and third detectors, AV-HuBERT LARGE "
                "(models/avhubert.py) and Auto-AVSR's AV conformer "
                "(models/auto_avsr.py), which the JAX package lacks, are "
                "chosen by 'architecture'")

# (JAX module, JAX name) -> how the port's parameters differ by idiom.
IDIOMS = {
    **{("inference/engine.py", n): Idiom(DEVICE, add=("device",))
       for n in ("ScoringEngine", "load_engine")},
    ("inference/predictor.py", "Predictor"):
        Idiom(DEVICE + "; " + ARCHITECTURE + ", whose configuration is "
              "model_config's default", add=("device",),
              defaults=(("model_config", "None"),)),
    **{("preprocessing/audio.py", n): Idiom(DEVICE, add=("device",))
       for n in ("preprocess_audio", "preprocess_audio_pcm")},
    **{("preprocessing/video.py", n): Idiom(DEVICE, add=("device",))
       for n in ("crop_track_on_device", "detect_and_crop_tracks",
                 "preprocess_video", "preprocess_video_tracks",
                 "preprocess_video_tracks_chunked")},
    ("training/data.py", "LipSyncDataset"): Idiom(DEVICE, add=("device",)),
    ("training/device_cache.py", "DeviceDatasetCache"):
        Idiom(DEVICE, add=("device",)),
    **{(m, "run_" + n): Idiom(DEVICE, add=("device",))
       for m, n in (("training/train.py", "training"),
                    ("training/finetune.py", "finetune"))},
    ("utils/device.py", "device_summary"): Idiom(DEVICE, add=("device",)),
    ("utils/device.py", "get_platform"):
        Idiom(DEVICE + "; a device where JAX prefers a platform name",
              rename=(("prefer", "device"),)),
    ("parallel/mesh.py", "make_mesh"):
        Idiom(DEVICE + "; the mesh's device type", add=("device_type",)),
    ("serving/config.py", "Settings"):
        Idiom("the service's device: 'cuda' where the JAX package's is "
              "'tpu'; " + ARCHITECTURE, add=("architecture",),
              defaults=(("device", "'cuda'"),)),
    ("inference/predictor.py", "PredictorConfig"):
        Idiom(ARCHITECTURE, add=("architecture",)),
    **{("models/" + m, n): Idiom(FLAX_DTYPE, drop=("dtype",))
       for m, n in (("artifact.py", "ArtifactDetector"),
                    ("artifact.py", "HighFrequencyDetector"),
                    ("artifact.py", "TemporalInconsistencyDetector"),
                    ("audio_encoder.py", "AudioEncoder"),
                    ("fusion.py", "CrossModalAttention"),
                    ("fusion.py", "LegacyFusionModule"),
                    ("layers.py", "MultiHeadAttention"),
                    ("layers.py", "TransformerEncoderLayer"),
                    ("temporal.py", "TemporalTransformer"),
                    ("visual_encoder.py", "VisualEncoder"))},
    ("models/classifier.py", "ClassificationHead"):
        Idiom(FLAX_FIELDS, drop=("dtype",), add=("in_dim",)),
    ("models/fusion.py", "FeatureProjection"):
        Idiom(FLAX_FIELDS, drop=("dtype",), add=("visual_dim", "audio_dim")),
    ("models/layers.py", "ConvBNAct"):
        Idiom(FLAX_FIELDS, drop=("dtype",), add=("in_channels",),
              rename=(("features", "out_channels"), ("strides", "stride"),
                      ("use_bias", "bias")),
              defaults=(("act", "True"),)),
    ("models/layers.py", "ResidualBlockND"):
        Idiom(FLAX_FIELDS, drop=("dtype",), add=("in_channels",),
              rename=(("features", "out_channels"), ("strides", "stride"))),
    ("models/layers.py", "Int8Conv"):
        Idiom("the flax layer becomes the lowering that ConvBNAct calls "
              "with its weights: the input, weight and bias are arguments "
              "and the widths come from the weight",
              drop=("features", "kernel_size", "use_bias", "dtype"),
              add=("x", "weight", "bias"), rename=(("strides", "stride"),)),
    ("models/lip_sync_model.py", "LipSyncModel"):
        Idiom(TORCH_DTYPE, defaults=(("dtype", "torch.float32"),)),
    ("models/lip_sync_model.py", "LipSyncModel.setup"):
        Idiom("flax's setup() reads the module's fields; torch's __init__ "
              "takes them as arguments", add=("config", "dtype")),
    ("models/lip_sync_model.py", "example_inputs"):
        Idiom(TORCH_DTYPE + "; " + DEVICE, add=("device",),
              defaults=(("dtype", "torch.float32"),)),
    **{("models/lip_sync_model.py", "LipSyncModel." + n):
       Idiom(TRAIN, drop=("train",))
       for n in ("encode_visual", "score_encoded")},
    ("ops/augment.py", "augment_batch"):
        Idiom(TORCH_STATE, rename=(("rng", "generator"),)),
    ("ops/pallas/hf_stem.py", "hf_stem_fused"):
        Idiom("Pallas's interpret mode: the port runs the kernel's twin for "
              "a CPU tensor; and PyTorch's names for the same tensors (the "
              "Laplacian and conv weights, the conv bias, BatchNorm's "
              "weight, which flax calls scale)", drop=("interpret",),
              rename=(("wlap", "lap_weight"), ("w1", "conv_weight"),
                      ("b1", "conv_bias"), ("bn_scale", "bn_weight"))),
    ("ops/pallas/mel_kernel.py", "log_mel_spectrogram_pallas"):
        Idiom("Pallas's interpret mode: the port runs the kernel's twin for "
              "a CPU tensor", drop=("interpret",)),
    ("preprocessing/lip_localizer.py", "forward"):
        Idiom("xp picks numpy or jax.numpy in the JAX package; the port's "
              "forward is numpy", drop=("xp",)),
    ("training/checkpoints.py", "load_checkpoint"):
        Idiom(TORCH_STATE + "; orbax restores into a template pytree, a "
              "state dict needs none", drop=("template",)),
    ("training/checkpoints.py", "load_checkpoint_partially"):
        Idiom(TORCH_STATE, rename=(("variables", "state_dict"),
                                   ("ckpt_variables", "ckpt_state_dict"))),
    ("training/checkpoints.py", "save_checkpoint"):
        Idiom(TORCH_STATE, rename=(("variables", "state_dict"),)),
    **{(m, n): Idiom(TORCH_STATE + "; " + DEVICE, drop=("state",),
                     add=("device",))
       for m, n in (("training/finetune.py", "collect_val_probs"),
                    ("training/train.py", "validate"))},
    ("training/optimizers.py", "ReduceLROnPlateau.step"):
        Idiom(TORCH_STATE, rename=(("opt_state", "optimizer"),)),
    ("training/optimizers.py", "current_learning_rate"):
        Idiom(TORCH_STATE, rename=(("opt_state", "optimizer"),)),
    ("training/optimizers.py", "label_params"):
        Idiom(TORCH_STATE, rename=(("params", "named_params"),)),
    ("training/optimizers.py", "make_phase_optimizer"):
        Idiom(TORCH_STATE + "; a torch optimizer is built over the "
              "parameters it updates", add=("named_params",)),
    ("training/steps.py", "TrainState"):
        Idiom(TORCH_STATE + "; a data-parallel rank's shard of the batch "
              "(one process per device under torch.distributed)",
              drop=("params", "batch_stats", "opt_state", "rng"),
              add=("model", "optimizer", "generator", "aug_generator",
                   "shard"),
              defaults=(("step", "0"),)),
    ("training/steps.py", "create_train_state"):
        Idiom(TORCH_STATE + "; flax's init traces an example batch, a "
              "torch module is built with its shapes; a data-parallel "
              "rank's shard", drop=("example_batch",), add=("shard",),
              rename=(("rng", "seed"),)),
    ("training/steps.py", "make_train_step"):
        Idiom(TORCH_STATE + "; the step reads the model and the optimizer "
              "from the TrainState it is given", drop=("model", "optimizer")),
}

JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                     for p in JAX_PKG.rglob("*.py"))


def _names(path: Path, private: bool = False) -> Set[str]:
    """Top-level defs and classes, and ``Class.method`` for the methods of
    each class; public ones only unless ``private``."""
    def keep(name):
        return private or not name.startswith("_")

    out = set()
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or not keep(node.name):
            continue
        out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out.update(
                f"{node.name}.{sub.name}" for sub in node.body
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                and keep(sub.name))
    return out


def _port_names(module: str) -> Set[str]:
    path = PORT_PKG / module
    return _names(path, private=True) if path.is_file() else set()


def test_the_walk_finds_both_packages():
    assert len(JAX_MODULES) >= 50
    assert "utils/zarrlite.py" in JAX_MODULES
    assert "ZarrGroup.create_array" in _names(JAX_PKG / "utils/zarrlite.py")


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    missing = []
    for name in sorted(_names(JAX_PKG / module)):
        key = (module, name)
        if key in NEEDS_NO_PORT:
            continue
        target_module, target = RENAMES.get(key, (module, name))
        if target not in _port_names(target_module):
            missing.append(f"{name} (port: {target_module}::{target})")
    assert not missing, f"{module}: no counterpart for {missing}"


@pytest.mark.parametrize("key", sorted(NEEDS_NO_PORT) + sorted(RENAMES),
                         ids=lambda k: "::".join(k))
def test_every_table_entry_is_current(key):
    """Each entry names a public JAX name that the port does not have under
    that name (an entry for something ported must go), with a reason or a
    rename target that exists."""
    module, name = key
    assert name in _names(JAX_PKG / module), key
    assert name not in _port_names(module), f"{key} is ported: drop it"
    if key in RENAMES:
        target_module, target = RENAMES[key]
        assert target in _port_names(target_module), RENAMES[key]
    else:
        assert len(NEEDS_NO_PORT[key]) > 10


def test_the_table_is_only_renames_and_the_recorded_exceptions():
    """The table holds the seven renames and the thirteen names that need
    no port; nothing else may be excused."""
    assert len(RENAMES) == 7 and len(NEEDS_NO_PORT) == 13
    excused: Dict[str, Set[str]] = {}
    for module, name in list(RENAMES) + list(NEEDS_NO_PORT):
        excused.setdefault(module, set()).add(name)
    assert set(excused) == {
        "ops/pallas/mel_kernel.py", "ops/pallas/hf_stem.py",
        "utils/profiling.py", "utils/device.py", "models/layers.py",
        "training/optimizers.py", "models/lip_sync_model.py",
        "models/convert.py", "ops/image.py", "parallel/mesh.py",
        "serving/schemas.py"}


# ── parameters ───────────────────────────────────────────────────────────

Signature = List[Tuple[str, Optional[str]]]


def _defs(path: Path) -> Dict[str, ast.AST]:
    """Top-level defs and classes, and ``Class.method``, by name."""
    out: Dict[str, ast.AST] = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _signature(node: ast.AST) -> Signature:
    """``(name, default source or None)`` of each parameter in order:
    ``*args`` and ``**kwargs`` as ``*args`` and ``**kwargs``. A class's are
    its ``__init__``'s without ``self``, or, where it has none, its
    annotated fields (a flax module's, a dataclass's, a pydantic model's)."""
    if isinstance(node, ast.ClassDef):
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef) and sub.name == "__init__":
                return _signature(sub)[1:]
        return [(f.target.id, None if f.value is None
                 else ast.unparse(f.value)) for f in node.body
                if isinstance(f, ast.AnnAssign)
                and isinstance(f.target, ast.Name)]
    a = node.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + [
        ast.unparse(d) for d in a.defaults]
    out: Signature = [(p.arg, d) for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append(("*" + a.vararg.arg, None))
    out += [(p.arg, None if d is None else ast.unparse(d))
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append(("**" + a.kwarg.arg, None))
    return out


def _translate(jax_sig: Signature, port_sig: Signature,
               idiom: Optional[Idiom]) -> Tuple[Signature, Signature]:
    """Both signatures with the idiom's differences taken out: the JAX one
    without ``drop``, renamed, with the idiom's defaults; the port's without
    ``add``."""
    if idiom is None:
        return jax_sig, port_sig
    rename, defaults = dict(idiom.rename), dict(idiom.defaults)
    jax_sig = [(rename.get(n, n), d) for n, d in jax_sig
               if n not in idiom.drop]
    jax_sig = [(n, defaults.get(n, d)) for n, d in jax_sig]
    return jax_sig, [(n, d) for n, d in port_sig if n not in idiom.add]


def _counterparts():
    """``(key, JAX signature, port signature)`` for every public JAX name
    that has a counterpart."""
    out = []
    for module in JAX_MODULES:
        jax_defs = _defs(JAX_PKG / module)
        for name in sorted(_names(JAX_PKG / module)):
            key = (module, name)
            if key in NEEDS_NO_PORT:
                continue
            target_module, target = RENAMES.get(key, (module, name))
            port_defs = _defs(PORT_PKG / target_module)
            if target in port_defs:
                out.append((key, _signature(jax_defs[name]),
                            _signature(port_defs[target])))
    return out


COUNTERPARTS = _counterparts()


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_counterpart_takes_the_jax_parameters(module):
    """Names, order and defaults equal, after the idiom's differences."""
    wrong = []
    for key, jax_sig, port_sig in COUNTERPARTS:
        if key[0] != module:
            continue
        want, got = _translate(jax_sig, port_sig, IDIOMS.get(key))
        if want != got:
            wrong.append(f"{key[1]}: JAX {want}, port {got}")
    assert not wrong, f"{module}: " + "; ".join(wrong)


@pytest.mark.parametrize("key", sorted(IDIOMS), ids=lambda k: "::".join(k))
def test_every_idiom_is_current(key):
    """Each entry excuses a difference that exists: its signatures differ
    without it, every name it drops, renames or sets a default for is a
    JAX parameter, every name it adds a port parameter, and it has a
    reason."""
    idiom = IDIOMS[key]
    found = [(j, p) for k, j, p in COUNTERPARTS if k == key]
    assert found, f"{key} has no counterpart"
    jax_sig, port_sig = found[0]
    jax_names = [n for n, _ in jax_sig]
    port_names = [n for n, _ in port_sig]
    assert jax_sig != port_sig, f"{key}: nothing differs, drop the entry"
    assert set(idiom.drop) | {a for a, _ in idiom.rename} <= set(jax_names)
    renamed = {dict(idiom.rename).get(n, n) for n in jax_names}
    assert {n for n, _ in idiom.defaults} <= renamed
    assert set(idiom.add) <= set(port_names) and not (
        set(idiom.add) & renamed)
    assert len(idiom.reason) > 10


def test_the_repaired_gaps_are_no_idiom():
    """K1 takes the Pallas kernel's parameters, the audio preprocessing
    the JAX one's, and the engine transfer_uint8 and max_in_flight: their
    entries excuse only interpret and the device."""
    assert IDIOMS[("ops/pallas/mel_kernel.py", "log_mel_spectrogram_pallas")
                  ] == Idiom(IDIOMS[("ops/pallas/mel_kernel.py",
                                     "log_mel_spectrogram_pallas")].reason,
                             drop=("interpret",))
    for key in (("preprocessing/audio.py", "preprocess_audio"),
                ("preprocessing/audio.py", "preprocess_audio_pcm"),
                ("inference/engine.py", "ScoringEngine")):
        assert IDIOMS[key] == Idiom(DEVICE, add=("device",)), key
    engine = dict(p for k, _, sig in COUNTERPARTS
                  if k == ("inference/engine.py", "ScoringEngine")
                  for p in sig)
    assert engine["transfer_uint8"] == "True"
    assert engine["max_in_flight"] == "2"


# ── the values a parameter takes ─────────────────────────────────────────
#
# The walk above holds names and defaults, not the values a parameter
# accepts. Every string literal that a JAX module compares against (an
# operand of ==, !=, in or not in, or an element of a tuple, list or set
# there) must appear as a string in the port's module of the same path (K1
# and K2 live under another), or stand in the table below with its reason:
# a value the JAX package tests for is a value its callers may pass.

PORT_MODULE = {m: t for (m, _), (t, _) in RENAMES.items() if m != t}
TPU = ("a platform check for the TPU; the port takes the torch device it "
       "is given (utils/device.py)")

# (JAX module, literal) -> why the port's module need not test for it.
STRING_IDIOMS = {
    ("inference/engine.py", "tpu"):
        TPU + ": bf16 where that device is CUDA",
    ("preprocessing/audio.py", "tpu"):
        TPU + ": K1 wherever its parameters are in range",
    ("preprocessing/audio.py", "1"):
        "LIPSYNC_TPU_PALLAS_MEL == '1' opts into the Pallas kernel in JAX; "
        "K1 is the port's default route, chosen from the parameters alone",
    ("training/finetune.py", ".pth"):
        "the JAX finetune tells a .pth file from an orbax directory by its "
        "suffix; the port's reads either kind of file as a torch state dict "
        "and a directory as a port checkpoint",
    ("training/optimizers.py", "visual_encoder"):
        "optax labels by module name; PhaseOptimizer labels by state-dict "
        "prefix ('visual_encoder.')",
    ("training/optimizers.py", "audio_encoder"):
        "optax labels by module name; PhaseOptimizer labels by state-dict "
        "prefix ('audio_encoder.')",
    ("training/optimizers.py", "learning_rate"):
        "optax's injected hyperparameter; torch's parameter groups hold "
        "'lr'",
}


def _compared_strings(path: Path) -> Set[str]:
    """The string literals that ``path`` compares against."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Compare):
            continue
        for operand in [node.left] + node.comparators:
            elts = (operand.elts if isinstance(
                operand, (ast.Tuple, ast.List, ast.Set)) else [operand])
            out.update(e.value for e in elts if isinstance(e, ast.Constant)
                       and isinstance(e.value, str))
    return out


def _strings(path: Path) -> Set[str]:
    if not path.is_file():
        return set()
    return {n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def test_the_string_walk_finds_what_the_jax_package_tests_for():
    """The lowering names of ``ConvBNAct`` (the port raised for
    ``shift_matmul`` until it took the lowering), the engine's platform
    check and the optimizer's labels."""
    assert {"shift_matmul", "int8"} <= _compared_strings(
        JAX_PKG / "models/layers.py")
    assert "tpu" in _compared_strings(JAX_PKG / "inference/engine.py")
    assert "visual_encoder" in _compared_strings(
        JAX_PKG / "training/optimizers.py")


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_compared_string_is_in_the_port(module):
    port = _strings(PORT_PKG / PORT_MODULE.get(module, module))
    missing = sorted(s for s in _compared_strings(JAX_PKG / module)
                     if s not in port and (module, s) not in STRING_IDIOMS)
    assert not missing, (f"{module} compares against {missing}, which the "
                         "port's module never names")


@pytest.mark.parametrize("key", sorted(STRING_IDIOMS),
                         ids=lambda k: "::".join(k))
def test_every_string_idiom_is_current(key):
    module, literal = key
    assert literal in _compared_strings(JAX_PKG / module), key
    assert literal not in _strings(PORT_PKG / PORT_MODULE.get(module, module))
    assert len(STRING_IDIOMS[key]) > 10


# ── the scripts tier ─────────────────────────────────────────────────────
#
# Every script under scripts/ that imports the JAX package or JAX, or runs
# the JAX package with ``python -m``, has a tool of the same name in
# lipsync_tpu_torch/tools/; every shell launcher there that runs the JAX
# package or one of those scripts has a launcher of the same name beside
# the tools. ROADMAP.md ("A′. The scripts tier") names none as left.

SCRIPTS = ROOT / "scripts"
TOOLS = PORT_PKG / "tools"


def _drives_the_jax_package(path: Path) -> bool:
    """The script imports JAX or the JAX package, or names one of the JAX
    package's modules as a string (what ``python -m`` runs)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names = [] if not node.value.startswith("lipsync_tpu.") else [
                node.value]
        else:
            continue
        if any(n.split(".")[0] in ("jax", "lipsync_tpu") for n in names):
            return True
    return False


DRIVING = sorted(p.stem for p in SCRIPTS.glob("*.py")
                 if _drives_the_jax_package(p))


def _launches_the_jax_package(path: Path) -> bool:
    """The launcher runs the JAX package (``lipsync_tpu.`` as a module or
    an import), or one of the scripts above, or another such launcher."""
    import re

    text = path.read_text()
    if re.search(r"\blipsync_tpu\.", text):
        return True
    if any(re.search(rf"scripts/{s}\.py\b", text) for s in DRIVING):
        return True
    return any(re.search(rf"\b{p.stem}\.sh\b", text)
               for p in SCRIPTS.glob("*.sh") if p != path
               and _launches_the_jax_package(p))


LAUNCHERS = sorted(p.stem for p in SCRIPTS.glob("*.sh")
                   if _launches_the_jax_package(p))


def test_the_script_walk_finds_the_jax_scripts():
    """36 scripts import JAX or the JAX package; two more run it with
    ``python -m``."""
    assert len(DRIVING) == 38
    assert {"run_synthetic_eval", "run_finetune_strict_venv",
            "validate_pipeline"} <= set(DRIVING)
    assert "download_grid_corpus" not in DRIVING


@pytest.mark.parametrize("script", DRIVING)
def test_every_jax_script_has_a_tool(script):
    assert (TOOLS / f"{script}.py").is_file(), (
        f"scripts/{script}.py has no lipsync_tpu_torch/tools/{script}.py")


def test_the_launcher_walk_finds_the_jax_launchers():
    """Six launchers start the JAX trainer; three more chain the JAX
    scripts or those launchers."""
    assert LAUNCHERS == sorted([
        "adapt_unseen_r4", "regen_r4", "run_finetune", "smoke_interference",
        "train_interference_r4", "train_union_flagship", "datagen_r5",
        "quick_finetune", "run_finetune_jenkins"])


@pytest.mark.parametrize("launcher", LAUNCHERS)
def test_every_jax_launcher_has_a_port_launcher(launcher):
    """The port's launcher exists, runs no JAX script or module and no JAX
    launcher (its comments may name them), and is executable like its JAX
    counterpart."""
    import os
    import re

    port = TOOLS / f"{launcher}.sh"
    assert port.is_file(), f"scripts/{launcher}.sh has no {port}"
    text = "\n".join(line for line in port.read_text().splitlines()
                     if not line.lstrip().startswith("#"))
    assert not re.search(r"\blipsync_tpu\.", text)
    assert not re.search(r"\bscripts/\w+\.sh\b", text)
    ran = set(re.findall(r"scripts/(\w+)\.py\b", text))
    assert ran <= {"merge_preprocessed_dirs"}, ran
    assert os.access(port, os.X_OK)


def test_scripts_left_are_the_roadmap_list():
    """ROADMAP.md's A′ names no script or launcher as left to port."""
    import re

    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("### A′. The scripts tier")
    section = text[start:text.index("\n### ", start)]
    assert "none left" in section.splitlines()[0]
    left = section[section.index("none left"):]
    if "Left, in order" in left:
        left = left[left.index("Left, in order"):]
        named = set(re.findall(r"`(\w+)(?:\.py|\.sh)?`", left))
        assert not named & (set(DRIVING) | set(LAUNCHERS)), named


# The scripts' flags: ``add_argument``'s first name and its default, and
# ``--device`` where a tool calls ``common.add_device_argument``.
DEVICE_FLAG = Idiom("the tool does device work: --device, cuda:0 by "
                    "default, 'cpu' runs the twins (tools/common.py)",
                    add=("--device",))
FLAG_IDIOMS = {
    **{name: DEVICE_FLAG for name in (
        "bench_coalesce_r5", "bench_int8", "bench_predictor", "bench_serving",
        "check_setup", "debug_clips", "eval_cross_tier", "eval_multiface",
        "eval_robustness_grid", "eval_shared_encoding", "eval_unseen_fakes",
        "filter_corrupt_videos", "fit_calibrator",
        "measure_articulation_bands", "probe_link_engine", "profile_forward",
        "profile_host", "run_grid_eval", "run_synthetic_eval",
        "validate_pipeline")},
    **{name: Idiom("the JAX script's --cpu is --device cpu",
                   drop=("--cpu",), add=("--device",))
       for name in ("bench_fold", "bench_train_scaling", "diagnose_int8",
                    "train_lip_localizer")},
    "precompute_training_tensors":
        Idiom("the JAX script's --platform (cpu or auto) is --device",
              drop=("--platform",), add=("--device",)),
    "eval_shared_encoding_flips":
        Idiom(DEVICE_FLAG.reason + "; the report goes to a file of its own "
              "beside the JAX script's, which stays as the JAX run wrote it",
              add=("--device",),
              defaults=(("--out", "REPO / 'docs' / 'eval' / "
                                  "'shared_encoding_flips_torch.json'"),)),
}


def _flags(path: Path) -> Signature:
    """``(flag, default source)`` of every ``add_argument`` (its first
    name), sorted, with ``--device`` for ``add_device_argument``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        called = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", None)
        if called == "add_argument":
            default = {k.arg: ast.unparse(k.value)
                       for k in node.keywords}.get("default")
            out.append((node.args[0].value, default))
        elif called == "add_device_argument":
            out.append(("--device", "'cuda:0'"))
    return sorted(out)


@pytest.mark.parametrize("script", DRIVING)
def test_every_tool_takes_the_script_flags(script):
    """The tool's flags and defaults equal the JAX script's, after the
    idiom's differences."""
    want, got = _translate(_flags(SCRIPTS / f"{script}.py"),
                           _flags(TOOLS / f"{script}.py"),
                           FLAG_IDIOMS.get(script))
    assert sorted(want) == got


@pytest.mark.parametrize("script", sorted(FLAG_IDIOMS))
def test_every_flag_idiom_is_current(script):
    idiom = FLAG_IDIOMS[script]
    jax_flags = dict(_flags(SCRIPTS / f"{script}.py"))
    port_flags = dict(_flags(TOOLS / f"{script}.py"))
    assert jax_flags != port_flags, f"{script}: nothing differs"
    assert set(idiom.drop) <= set(jax_flags) and not idiom.rename
    assert set(idiom.add) <= set(port_flags) - set(jax_flags)


# ── the root drivers ─────────────────────────────────────────────────────
#
# The repo's root bench.py and __graft_entry__.py drive only the JAX
# package; each has its tool. Every top-level def of the driver, private
# ones too, has a def of the same name in the tool, or stands in the table
# below with its tool's name for it or its reason; so does every key of the
# JSON line that bench.py prints (the tool's ``run`` returns one dict
# literal) and every JAX configuration switch the driver sets.

ROOT_DRIVERS = {"bench.py": "bench", "__graft_entry__.py": "graft_entry"}
FALLBACK = ("the CPU fall-back when the remote accelerator is unreachable: "
            "the tool's --device names the device, and cuda:0 without CUDA "
            "raises (utils/device.py::get_device)")
CACHE = ("JAX's persistent compilation cache; the port's kernels build "
         "once per checkout (ops/kernels/build.py)")
# (driver, name) -> the tool's name for it, or why it has none.
ROOT_EXCEPTIONS = {
    ("bench.py", "_compiled_flops"): "_counted_flops",
    ("bench.py", "_accelerator_reachable"): FALLBACK,
    ("bench.py", "jax_platforms"): FALLBACK,
    ("bench.py", "note"): "printed only after " + FALLBACK,
    ("bench.py", "jax_compilation_cache_dir"): CACHE,
    ("bench.py", "jax_persistent_cache_min_entry_size_bytes"): CACHE,
    ("bench.py", "jax_persistent_cache_min_compile_time_secs"): CACHE,
    ("__graft_entry__.py", "_dryrun_multichip_inproc"):
        "JAX runs the whole dry run in one process over n devices (and "
        "re-executes itself on n virtual CPU devices to get them); torch "
        "trains one process per rank, so the tool's dryrun_multichip "
        "spawns the ranks (_train_rank) and serves in process",
}


def _printed_keys(path: Path) -> Set[str]:
    """The string keys of the dict literal with a ``"metric"`` key and of
    the dicts nested in it."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return {k.value for sub in ast.walk(node)
                    if isinstance(sub, ast.Dict) for k in sub.keys
                    if isinstance(k, ast.Constant)}
    return set()


def _jax_switches(path: Path) -> Set[str]:
    """The names that ``jax.config.update`` sets."""
    return {node.args[0].value for node in ast.walk(ast.parse(
        path.read_text())) if isinstance(node, ast.Call)
        and ast.unparse(node.func) == "jax.config.update"}


def _root_items(driver: str) -> Set[str]:
    path = ROOT / driver
    return (_names(path, private=True) | _printed_keys(path)
            | _jax_switches(path))


@pytest.mark.parametrize("driver", sorted(ROOT_DRIVERS))
def test_every_root_driver_has_its_tool(driver):
    tool = TOOLS / f"{ROOT_DRIVERS[driver]}.py"
    assert tool.is_file(), f"{driver} has no {tool}"
    ported = _names(tool, private=True) | _printed_keys(tool)
    missing = []
    for item in sorted(_root_items(driver)):
        excused = ROOT_EXCEPTIONS.get((driver, item))
        if item not in ported and excused not in ported:
            if excused is None:
                missing.append(item)
    assert not missing, f"{driver}: nothing in {tool.name} for {missing}"


def test_the_root_walk_sees_the_drivers():
    assert {"main", "_measure", "_accelerator_reachable"} <= _root_items(
        "bench.py")
    assert {"value", "engine_link_utilization", "platform", "note",
            "jax_compilation_cache_dir"} <= _root_items("bench.py")
    assert {"entry", "dryrun_multichip", "_initialized_device_count",
            "_dryrun_multichip_inproc"} <= _root_items("__graft_entry__.py")


@pytest.mark.parametrize("key", sorted(ROOT_EXCEPTIONS),
                         ids=lambda k: "::".join(k))
def test_every_root_exception_is_current(key):
    """Each entry names something the driver has and its tool has not
    under that name: a rename whose target the tool has, or a reason."""
    driver, item = key
    tool = TOOLS / f"{ROOT_DRIVERS[driver]}.py"
    ported = _names(tool, private=True) | _printed_keys(tool)
    assert item in _root_items(driver) and item not in ported, key
    target = ROOT_EXCEPTIONS[key]
    assert target in ported or len(target) > 40, key
