"""What the operational tools share: the ``--device`` flag, and the line
between a file that a host stage could not use, which a tool records and
skips, and every other failure, which ends the run.

The JAX package's scripts catch every exception per file. Copied as they
are, a kernel that fails to build or launch on the card would read as "0
clips precomputed" or as an evaluation full of error rows: the kernel
wrappers raise ``RuntimeError`` and ``ValueError``, as ingest does for a
file it cannot decode. So the tools skip a file only when the failure
came out of a host stage (:func:`host_stage_failed`).
"""

from __future__ import annotations

import argparse

from lipsync_tpu_torch.preprocessing import ingest


class HostStageError(Exception):
    """An input file that a host stage could not use: no audio stream, no
    face track. The tool records the file and goes on."""


def host_stage_failed(exc: BaseException) -> bool:
    """Whether ``exc`` says that one input file was unusable (ingest could
    not read it, or a :class:`HostStageError`), and not that the program
    failed."""
    return isinstance(exc, HostStageError) or ingest.is_read_failure(exc)


def add_device_argument(p: argparse.ArgumentParser) -> None:
    """``--device``, ``cuda:0`` by default (raises where CUDA is absent):
    where the crops, the log-mel and the model run."""
    p.add_argument("--device", default="cuda:0",
                   help="torch device for the device work (default: cuda:0; "
                        "'cpu' runs the kernels' plain twins on the CPU)")
