"""The port does all that the JAX package does: every public top-level
``def``/``class`` of every module of ``lipsync_tpu/``, and every public
method of a public class, has a counterpart of the same name in the port's
module of the same path, or stands in the table below as a rename or as
needing no port, with its reason (ROADMAP.md gives the same reasons).

The walk reads both packages with ``ast``; it imports neither.
"""

import ast
from pathlib import Path
from typing import Dict, Set

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


# ── the scripts tier ─────────────────────────────────────────────────────
#
# Every script under scripts/ that imports the JAX package or JAX, or runs
# the JAX package with ``python -m``, has a tool of the same name in
# lipsync_tpu_torch/tools/, or stands here; ROADMAP.md ("A′. The scripts
# tier") lists the same scripts in the order they are to be ported.

SCRIPTS = ROOT / "scripts"
TOOLS = PORT_PKG / "tools"
SCRIPTS_LATER = {
    # the pinned fine-tune launcher
    "run_finetune_strict_venv",
    # the profilers
    "profile_forward", "profile_host",
    # the benchmarks, with the benchmark
    "bench_coalesce_r5", "bench_fold", "bench_haar", "bench_int8",
    "bench_predictor", "bench_serving", "bench_train_scaling",
    "diagnose_int8",
}


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


def test_the_script_walk_finds_the_jax_scripts():
    """36 scripts import JAX or the JAX package; two more run it with
    ``python -m``."""
    assert len(DRIVING) == 38
    assert {"run_synthetic_eval", "run_finetune_strict_venv",
            "validate_pipeline"} <= set(DRIVING)
    assert "download_grid_corpus" not in DRIVING


@pytest.mark.parametrize("script", DRIVING)
def test_every_jax_script_has_a_tool(script):
    assert (TOOLS / f"{script}.py").is_file() or script in SCRIPTS_LATER, (
        f"scripts/{script}.py has no lipsync_tpu_torch/tools/{script}.py "
        "and is not in SCRIPTS_LATER")


@pytest.mark.parametrize("script", sorted(SCRIPTS_LATER))
def test_every_script_left_is_current(script):
    """An entry names a script that drives the JAX package and has no
    tool yet (a ported one must go)."""
    assert script in DRIVING, script
    assert not (TOOLS / f"{script}.py").exists(), f"{script} is ported"


def test_scripts_left_are_the_roadmap_list():
    import re

    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("Left, in order",
                       text.index("### A′. The scripts tier"))
    section = text[start:text.index("\n### ", start)]
    named = set(re.findall(r"`(\w+)(?:\.py)?`", section))
    assert named & set(DRIVING) == SCRIPTS_LATER
