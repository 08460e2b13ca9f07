"""Pinned staging of the engine's uploads on a copy stream.

On a CUDA device the engine moves each group's host arrays through a
:class:`StagingRing`: a few slots, each a pinned host buffer and a device
buffer of the same size, grown to the largest upload seen. An upload takes
a free slot, copies the arrays into its pinned buffer on the host (one
``copy_`` each, which releases the interpreter lock and uses torch's
intra-op threads), then copies the pinned buffer to the device buffer on
the device's copy stream and records an event there. The stream that
reads the arrays waits on that event; when its work is enqueued the slot is
released with an event recorded after it. So:

- the host rewrites a slot's pinned buffer only after waiting on the
  event of the copy that last read it;
- the copy stream writes a slot's device buffer only after waiting on the
  event recorded after the work that last read it;
- a device buffer is dropped (to grow it) only after the host has waited
  on that event.

The device buffers are allocated once per size, never per upload, so the
copy stream never waits on the caching allocator for a block that the
compute stream freed.

The stream and event operations go through a link (:class:`CudaLink` on
the card), so the bookkeeping can be driven with fake events on the CPU.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from lipsync_tpu_torch.utils import profiling

_ALIGN = 256  # bytes between the arrays of one slot


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _view(buf: torch.Tensor, offset: int, like: torch.Tensor) -> torch.Tensor:
    """``like``'s dtype, shape and strides over ``buf``'s bytes from
    ``offset`` (``like`` is dense). The strides are ``like``'s own, as
    ``.to(device)`` keeps them, since a kernel may pick its algorithm by
    them (numpy gives a new axis of one the stride 0)."""
    n = like.numel() * like.element_size()
    return buf[offset:offset + n].view(like.dtype).as_strided(
        like.shape, like.stride())


class CudaLink:
    """What a ring does on one CUDA device: pinned and device buffers,
    events, stream waits, and the two copies (host to pinned, pinned to
    device on the device's own copy stream)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)

    def copying(self):
        """The copy stream as the current stream of its device."""
        return torch.cuda.stream(self.copy_stream)

    def host(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def device_buffer(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, device=self.device)

    @staticmethod
    def event(stream) -> torch.cuda.Event:
        e = torch.cuda.Event()
        e.record(stream)
        return e

    @staticmethod
    def wait(stream, event) -> None:
        stream.wait_event(event)

    @staticmethod
    def sync(event) -> None:
        event.synchronize()

    @staticmethod
    def stage(dst: torch.Tensor, src: torch.Tensor) -> None:
        dst.copy_(src)

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        with self.copying():
            dst.copy_(src, non_blocking=True)


class Slot:
    """One pinned buffer and its device twin, with the events that say
    when each may be rewritten. ``held`` while a caller owns it."""

    __slots__ = ("host", "device", "copied", "consumed", "held")

    def __init__(self):
        self.host: Optional[torch.Tensor] = None
        self.device: Optional[torch.Tensor] = None
        self.copied = None    # after the last pinned-to-device copy
        self.consumed = None  # after the work that last read the device half
        self.held = False


class StagingRing:
    """``slots`` staging slots over one link, safe under concurrent
    callers: :meth:`acquire` hands a slot to one caller until
    :meth:`release`."""

    def __init__(self, slots: int, link):
        self.link = link
        self.slots = [Slot() for _ in range(max(1, int(slots)))]
        self._lock = threading.Lock()
        self._next = 0

    def acquire(self) -> Optional[Slot]:
        """The next slot no caller holds, in turn (so the one whose work
        was enqueued longest ago), or None when every slot is held."""
        with self._lock:
            n = len(self.slots)
            for i in range(n):
                slot = self.slots[(self._next + i) % n]
                if not slot.held:
                    slot.held = True
                    self._next = (self._next + i + 1) % n
                    return slot
        return None

    def fill(self, slot: Slot, arrays: Sequence[np.ndarray]
             ) -> List[torch.Tensor]:
        """Stage ``arrays`` in ``slot``'s pinned buffer and enqueue its copy
        to the device on the copy stream; returns the arrays' device views
        (read them only after :meth:`ready`). The caller may reuse the
        arrays as soon as this returns. The buffers and views are normal
        tensors whether or not the caller runs under
        ``torch.inference_mode`` (a slot made under it could not be
        rewritten outside it)."""
        with torch.inference_mode(False):
            return self._fill(slot, arrays)

    def _fill(self, slot: Slot, arrays: Sequence[np.ndarray]
              ) -> List[torch.Tensor]:
        link = self.link
        srcs = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        offsets, need = [], 0
        for s in srcs:
            offsets.append(need)
            need += _aligned(s.numel() * s.element_size())
        if slot.copied is not None:
            link.sync(slot.copied)  # the pinned half is free again
        if slot.host is None or slot.host.numel() < need:
            if slot.consumed is not None:
                link.sync(slot.consumed)  # nothing reads the device half
            slot.host = slot.device = None
            slot.host, slot.device = link.host(need), link.device_buffer(need)
            slot.copied = slot.consumed = None
        with profiling.span("engine.stage"):
            for s, off in zip(srcs, offsets):
                link.stage(_view(slot.host, off, s), s)
        if slot.consumed is not None:
            link.wait(link.copy_stream, slot.consumed)
        profiling.device_start()  # the span's device time: the copy alone
        link.copy(slot.device[:need], slot.host[:need])
        slot.copied = link.event(link.copy_stream)
        return [_view(slot.device, off, s) for s, off in zip(srcs, offsets)]

    def ready(self, slot: Slot, stream) -> None:
        """Make ``stream`` wait for ``slot``'s copy before what it reads."""
        self.link.wait(stream, slot.copied)

    def release(self, slot: Slot, stream) -> None:
        """Hand ``slot`` back once every read of it is enqueued on
        ``stream``: the next copy into it waits for those reads."""
        slot.consumed = self.link.event(stream)
        with self._lock:
            slot.held = False
