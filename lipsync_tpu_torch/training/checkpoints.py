"""Checkpoint directories with the JAX package's selection policy.

Counterpart of ``training/checkpoints.py`` in the JAX package, which saves
orbax directories. orbax is a JAX library, so a port checkpoint is a
directory that holds the model's ``state_dict`` as ``model.pth`` (the
reference checkpoint's parameter names, so ``torch.load`` + the reference
model, the JAX package's ``load_torch_checkpoint`` and the port's
``load_engine`` all read it) and the same ``metadata.json`` sidecar
(epoch, phase, losses, input geometry, ``f1_threshold``...).

In a data-parallel group every rank holds the same weights: rank 0 writes,
and every rank waits at a barrier until the directory is complete.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from lipsync_tpu_torch.parallel import mesh as mesh_lib

WEIGHTS_FILE = "model.pth"


def is_checkpoint_dir(path: Path) -> bool:
    return (Path(path) / WEIGHTS_FILE).is_file()


def save_checkpoint(
    path: Path,
    state_dict: Mapping[str, torch.Tensor],
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Replace ``path`` with a checkpoint directory: ``model.pth`` (CPU
    copies of ``state_dict``) + ``metadata.json``. In a process group only
    rank 0 writes, and every rank returns once it has."""
    if mesh_lib.rank() == 0:
        path = Path(path)
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
                   path / WEIGHTS_FILE)
        if metadata is not None:
            (path / "metadata.json").write_text(
                json.dumps(metadata, indent=2))
    mesh_lib.barrier()


def load_checkpoint(path: Path) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a checkpoint directory, on the CPU."""
    path = Path(path)
    if not is_checkpoint_dir(path):
        raise FileNotFoundError(f"No {WEIGHTS_FILE} in {path}")
    return torch.load(path / WEIGHTS_FILE, map_location="cpu",
                      weights_only=True)


def load_metadata(path: Path) -> Dict[str, Any]:
    meta = Path(path) / "metadata.json"
    return json.loads(meta.read_text()) if meta.exists() else {}


def load_checkpoint_partially(
    state_dict: Mapping[str, torch.Tensor],
    ckpt_state_dict: Mapping[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Transfer-learning load: each entry of the fresh ``state_dict`` takes
    the checkpoint's tensor of the same name and shape; a missing name keeps
    the fresh value, and a shape mismatch keeps it too and is listed.
    Returns ``(merged, skipped_names)``."""
    merged: Dict[str, torch.Tensor] = {}
    skipped: List[str] = []
    for name, fresh in state_dict.items():
        old = ckpt_state_dict.get(name)
        if old is None:
            merged[name] = fresh
        elif tuple(old.shape) != tuple(fresh.shape):
            skipped.append(name)
            merged[name] = fresh
        else:
            merged[name] = old
    return merged, skipped
