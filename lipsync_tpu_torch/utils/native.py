"""Build the repository's native host libraries and load them with ctypes.

The JAX package builds ``native/*.cc`` with ``make -C native``, which writes
its ``.so`` files into ``native/``. The port leaves that directory as it is:
it compiles the same sources, with the Makefile's flags, into
``build/lipsync_tpu_torch_native/lib<name>-<hash>.so`` beside the package.
The hash covers the source and the command, so an edited source rebuilds and
an unchanged one is reused. A library is built at first use, never at
import; several processes may build the same one at once (each writes its
own temporary file and renames it into place).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO_ROOT / "native"
BUILD_DIR = REPO_ROOT / "build" / "lipsync_tpu_torch_native"
LIBRARIES = ("ingest", "haar", "mux")

# native/Makefile: CXXFLAGS, and LDLIBS for the two FFmpeg users.
CXXFLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-shared")
FFMPEG_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale",
               "-lswresample")

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def _has_avx512f() -> bool:
    """The Makefile's probe: ``-mavx512f`` for haar.cc when the building
    host has it (haar.cc picks its path at run time as well)."""
    try:
        return "avx512f" in Path("/proc/cpuinfo").read_text()
    except OSError:
        return False


def command(name: str, out: Path) -> List[str]:
    """The compiler command that builds ``native/<name>.cc`` into ``out``."""
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS]
    if name == "haar" and _has_avx512f():
        cmd.append("-mavx512f")
    cmd += ["-o", str(out), str(NATIVE_DIR / f"{name}.cc")]
    if name != "haar":
        cmd += FFMPEG_LIBS
    return cmd


def library_path(name: str, build_dir: Path = BUILD_DIR) -> Path:
    src = (NATIVE_DIR / f"{name}.cc").read_bytes()
    flags = " ".join(command(name, Path("out"))).encode()
    digest = hashlib.sha256(src + flags).hexdigest()
    return Path(build_dir) / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str] = LIBRARIES,
          build_dir: Optional[Path] = None) -> Dict[str, Path]:
    """Compile every named library that is missing from ``build_dir``;
    returns each library's path. Raises ``RuntimeError`` with the
    compiler's output if a build fails."""
    build_dir = Path(build_dir or BUILD_DIR)
    paths = {}
    for name in names:
        out = library_path(name, build_dir)
        if not out.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(command(name, tmp), capture_output=True,
                                  text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building native/{name}.cc failed:\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, out)
        paths[name] = out
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``native/<name>.cc``, built on first use."""
    with _lock:
        path = build([name])[name]
        lib = _loaded.get(path)
        if lib is None:
            lib = _loaded[path] = ctypes.CDLL(str(path))
        return lib
