"""The port stands alone: no JAX, no flax, nothing of the JAX package, no
pydantic, httpx or fastapi, and no silent fall-back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lipsync_tpu_torch.utils.device import get_device

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "lipsync_tpu_torch"
# The card tests and chip_smoke.py run where JAX is absent: they and their
# helper import none.
CARD_TESTS = sorted((ROOT / "tests").glob("test_torch_*_card.py"))
SOURCES = (sorted(PKG.rglob("*.py")) + CARD_TESTS
           + [ROOT / "tests" / "torch_card.py", ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "flax", "optax", "orbax", "lipsync_tpu", "pydantic",
             "httpx", "fastapi")


def test_importing_every_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pydantic', 'httpx', "
        "'fastapi') "
        "or m == 'lipsync_tpu' or m.startswith('lipsync_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_nothing_of_jax(path):
    text = path.read_text()
    assert "lipsync_tpu." not in text
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _forbidden_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN[:4] + ("jaxlib",)
                  or m == "lipsync_tpu" or m.startswith("lipsync_tpu."))


def _rank_modules(rank, device, out):
    (Path(out) / f"rank{rank}.txt").write_text(
        "\n".join(_forbidden_modules()))


def test_spawned_ranks_and_chip_smoke_load_no_jax(tmp_path):
    """The ranks that ``parallel.mesh.run_group`` spawns (the data-parallel
    tests' groups, the trainer's one process per card) start clean of JAX
    and the JAX package, and so do ``chip_smoke.py`` and the card test
    modules with the parallel package imported."""
    from lipsync_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.run_group(_rank_modules, 2, "cpu", f"file://{tmp_path}/store",
                       args=(str(tmp_path),), join_timeout_s=120)
    for rank in range(2):
        assert (tmp_path / f"rank{rank}.txt").read_text() == "", rank
    code = (
        "import importlib, sys\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tests')\n"
        f"for m in {[p.stem for p in CARD_TESTS]!r}:\n"
        "    importlib.import_module(m)\n"
        "from lipsync_tpu_torch.parallel import collectives, mesh\n"
        "from lipsync_tpu_torch.training import train, finetune\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax') "
        "or m == 'lipsync_tpu' or m.startswith('lipsync_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_get_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device()
    with pytest.raises(RuntimeError):
        get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")


def _native_sources():
    """(mtime, sha256) of every source file under ``native/`` (the ``.so``
    files there are the JAX package's build outputs, which its own tests
    may write at any time)."""
    import hashlib

    return {
        p.name: (p.stat().st_mtime_ns, hashlib.sha256(p.read_bytes()).digest())
        for p in sorted((ROOT / "native").iterdir())
        if p.is_file() and p.suffix != ".so"
    }


def test_native_libraries_build_outside_native(tmp_path):
    """The port compiles native/*.cc into a build directory of its own: it
    writes nothing under native/, each library loads with the symbols its
    binding declares, and building and binding them loads no JAX."""
    before = _native_sources()
    assert {"Makefile", "ingest.cc", "haar.cc", "mux.cc"} <= set(before)
    build_dir = tmp_path / "native_build"
    code = (
        "import ctypes, sys\n"
        "from lipsync_tpu_torch.utils import native\n"
        "from lipsync_tpu_torch.preprocessing import haar, ingest, mux\n"
        f"paths = native.build(build_dir={str(build_dir)!r})\n"
        "symbols = {'ingest': 'ingest_read_video', 'haar': 'haar_detect',\n"
        "           'mux': 'mux_write_video_ex'}\n"
        "for name, path in paths.items():\n"
        "    getattr(ctypes.CDLL(str(path)), symbols[name])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax') or m.startswith('lipsync_tpu.'))\n"
        "assert not bad, bad\n"
        "print(sorted(p.name for p in paths.values()))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    built = sorted(p.name for p in build_dir.iterdir())
    assert len(built) == 3 and all(n.endswith(".so") for n in built), built
    assert _native_sources() == before


def test_entry_points_default_to_cuda(monkeypatch):
    """Without device="cpu" an entry point asks for CUDA and raises here."""
    import numpy as np

    from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess_audio_pcm(np.ones(16000, np.float32))

    from types import SimpleNamespace

    from lipsync_tpu_torch.training.device_cache import DeviceDatasetCache
    from lipsync_tpu_torch.training.finetune import run_finetune
    from lipsync_tpu_torch.training.train import run_training

    for entry in (run_training, run_finetune):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(SimpleNamespace())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceDatasetCache(SimpleNamespace())


def test_server_and_worker_ask_for_cuda(tmp_path, monkeypatch):
    """``Settings.device`` defaults to "cuda": with a real model file the
    server's start-up and the standalone worker raise where there is no
    CUDA; they never serve from the CPU unasked."""
    from lipsync_tpu_torch.models import LipSyncModel
    from lipsync_tpu_torch.serving import worker
    from lipsync_tpu_torch.serving.app import AppState, Server
    from lipsync_tpu_torch.serving.config import Settings

    path = tmp_path / "w.pth"
    torch.save(LipSyncModel().state_dict(), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = Settings(model_path=path, port=0,
                        sqlite_db_path=str(tmp_path / "jobs.db"))
    assert settings.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(AppState(settings=settings))
    monkeypatch.setenv("MODEL_PATH", str(path))
    monkeypatch.setenv("SQLITE_DB_URL", str(tmp_path / "w.db"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.main()
