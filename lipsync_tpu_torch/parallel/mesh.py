"""Device lists, batch padding and sharding, and process groups.

Counterpart of ``parallel/mesh.py`` in the JAX package. There one program
runs over the global batch on a 1-D ``data`` mesh: parameters replicate and
axis 0 shards in contiguous blocks in device order. The port keeps those
numbers in two forms:

* **inference** runs in one process over a *mesh*, a list of
  ``torch.device`` (a device may appear more than once: ``[cpu] * 8`` is
  eight shards on the host). The engine splits each bucket into contiguous
  shards (:func:`shard_bounds`) and runs one model replica per distinct
  device; the only cross-shard number, int8's activation scale, is
  reduced in lockstep (:class:`Lockstep`).
* **training** runs one process per device under ``torch.distributed``:
  gloo on the CPU, NCCL on CUDA. Every rank builds the same global batch
  and keeps its contiguous block (:func:`shard_rows`); BatchNorm, the
  losses and the gradients reduce over the group
  (``parallel/collectives.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# How long a collective or a lockstep barrier waits for its peers before it
# fails: a rank that died must fail the others, not hang them.
TIMEOUT_S = 300.0


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              device_type: str = "cuda") -> List[torch.device]:
    """The first ``n_devices`` devices, fewer if fewer exist, as the JAX
    package's ``make_mesh``. ``devices=None`` lists every CUDA device for
    ``device_type="cuda"`` (raises without CUDA); for ``"cpu"`` it is the
    host ``n_devices`` times (torch has one CPU device; the tests run
    several shards on it, as JAX's virtual CPU devices do)."""
    if devices is None:
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; pass "
                                   "device_type='cpu' for a host mesh")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device(device_type)] * max(1, n_devices or 1)
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_batch_to_multiple(batch: Dict[str, np.ndarray],
                          n_dev: int) -> Dict[str, np.ndarray]:
    """Pad every array's axis 0 up to a multiple of ``n_dev`` by repeating
    the last row, and attach a 0/1 ``sample_mask`` of the real rows (always,
    even when nothing is padded). The losses and the accuracy drop the
    masked rows; train-mode BatchNorm still sees them, as in the JAX
    package (its documented caveat)."""
    b = int(next(iter(batch.values())).shape[0])
    target = pad_to_multiple(b, n_dev)
    mask = np.zeros((target,), np.float32)
    mask[:b] = 1.0
    if target != b:
        batch = {k: np.concatenate([v, np.repeat(v[-1:], target - b, axis=0)])
                 for k, v in batch.items()}
    else:
        batch = dict(batch)
    batch["sample_mask"] = mask
    return batch


def shard_bounds(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """``n_shards`` contiguous equal blocks of ``range(n)``, in order."""
    if n % n_shards:
        raise ValueError(f"{n} rows do not split into {n_shards} shards")
    size = n // n_shards
    return [(i * size, (i + 1) * size) for i in range(n_shards)]


def shard_rows(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """Rank ``rank``'s contiguous block of axis 0 of every entry."""
    n = int(next(iter(batch.values())).shape[0])
    lo, hi = shard_bounds(n, world)[rank]
    return {k: v[lo:hi] for k, v in batch.items()}


def distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    """The mesh's devices without repeats, in order."""
    out: List[torch.device] = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


# ── in-process shards in lockstep ─────────────────────────────────────────


_local = threading.local()


class Lockstep:
    """Runs one callable per shard, each in its own thread, so that a
    reduction over every shard (:func:`all_max`) can sit in the middle of
    a forward: each shard posts its value and waits at a barrier for the
    others. Every shard must reach the same reductions in the same order
    (they run the same model). A shard that raises aborts the barrier, so
    the others fail instead of waiting."""

    def __init__(self, n: int):
        self.n = n
        self._barrier = threading.Barrier(n, timeout=TIMEOUT_S)
        self._slots: List[Optional[torch.Tensor]] = [None] * n

    def run(self, fns: Sequence[Callable[[], Any]]) -> List[Any]:
        results: List[Any] = [None] * self.n
        errors: List[Optional[BaseException]] = [None] * self.n

        def work(i: int) -> None:
            _local.shard = (self, i)
            try:
                results[i] = fns[i]()
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                errors[i] = e
                self._barrier.abort()
            finally:
                _local.shard = None

        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors
                      if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return results

    def _all_max(self, i: int, value: torch.Tensor) -> torch.Tensor:
        self._slots[i] = value
        self._barrier.wait()
        out = torch.stack([s.to(value.device) for s in self._slots]).max()
        self._barrier.wait()  # nobody overwrites a slot still being read
        return out


@contextlib.contextmanager
def owning_frames(lo: int, hi: int):
    """While open, the calling shard owns frames ``[lo, hi)`` of the
    channels-first activations it encodes (axis 2); the frames around them
    are a halo whose deeper values are not the whole track's, and
    :func:`frame_core` tells a reduction to skip them."""
    prev = getattr(_local, "core", None)
    _local.core = (lo, hi)
    try:
        yield
    finally:
        _local.core = prev


def frame_core() -> Optional[Tuple[int, int]]:
    """The frames the calling shard owns (:func:`owning_frames`), or None."""
    return getattr(_local, "core", None)


def all_max(value: torch.Tensor) -> torch.Tensor:
    """The maximum of ``value`` (a scalar tensor) over the shards of the
    :class:`Lockstep` that runs the calling thread; ``value`` itself
    outside one."""
    shard = getattr(_local, "shard", None)
    if shard is None:
        return value
    group, i = shard
    return group._all_max(i, value)


# ── process groups ────────────────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class ProcessShard:
    """This process's place in the group: rank ``rank`` of ``world``."""

    rank: int
    world: int


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def process_shard() -> Optional[ProcessShard]:
    """This process's :class:`ProcessShard`, or None outside a group."""
    return ProcessShard(rank(), world_size()) if initialized() else None


def init_group(init_method: str, rank: int, world: int,
               device: torch.device, timeout_s: float = TIMEOUT_S) -> None:
    """Join a group of ``world`` processes as ``rank`` (gloo on the CPU,
    NCCL on CUDA). ``init_method`` is ``tcp://host:port``, ``file://path``
    or ``env://``."""
    device = torch.device(device)
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend_for(device), init_method=init_method, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
        **kwargs)


def launched_by_torchrun() -> bool:
    """True when ``python -m torch.distributed.run`` started this process
    (it sets these variables)."""
    return all(k in os.environ
               for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"))


def join_from_environment(device_type: str) -> Optional[torch.device]:
    """Under ``torch.distributed.run``: join its group (once) and return
    this rank's device, ``cuda:LOCAL_RANK`` or the CPU. None otherwise."""
    if not launched_by_torchrun():
        return None
    local = int(os.environ["LOCAL_RANK"])
    device = (torch.device("cuda", local) if device_type == "cuda"
              else torch.device("cpu"))
    if not initialized():
        init_group("env://", int(os.environ["RANK"]),
                   int(os.environ["WORLD_SIZE"]), device)
    return device


def _group_entry(i: int, fn: Callable, world: int, device_type: str,
                 init_method: str, args: Tuple) -> None:
    device = (torch.device("cuda", i) if device_type == "cuda"
              else torch.device("cpu"))
    init_group(init_method, i, world, device)
    try:
        fn(i, device, *args)
    finally:
        leave_group()


def run_group(fn: Callable, world: int, device_type: str, init_method: str,
              args: Tuple = (),
              join_timeout_s: Optional[float] = TIMEOUT_S) -> None:
    """Start ``world`` processes (spawned: a parent with threads must not
    fork) that join one group at ``init_method`` and call
    ``fn(rank, device, *args)``, rank ``r`` on ``cuda:r`` or the CPU.
    Raises what a rank raised, or ``TimeoutError`` (after killing them)
    when they are not done within ``join_timeout_s`` (None: no limit).
    ``fn`` must be a module-level function."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _group_entry, args=(fn, world, device_type, init_method, args),
        nprocs=world, start_method="spawn", join=False)
    deadline = (None if join_timeout_s is None
                else time.monotonic() + join_timeout_s)
    try:
        while not ctx.join(timeout=None if deadline is None else
                           max(0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} ranks not done after {join_timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def barrier() -> None:
    if initialized():
        dist.barrier()


def leave_group() -> None:
    if initialized():
        dist.destroy_process_group()
