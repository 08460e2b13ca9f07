"""The rate of the engine's whole uploads: the program's counter
``engine.upload_bytes`` over the seconds its ``engine.upload`` spans took
from the host's first byte to the device's last, that is the host's copy
into pinned memory (the host seconds of each upload's ``engine.stage``
children, where the program stages) and then the copy to the device (the
span's device seconds), in GB/s. A program that stages nothing reads as
``engine.upload_gbps.bulk``, whose device seconds then hold the whole
pageable copy."""

from benchmark.core import program


def read(view):
    uploads = program.spans(view, "engine.upload")
    seconds = program.device_s(uploads or [])
    moved = program.counter("engine.upload_bytes")
    if not seconds or not moved:
        return None
    ids = {r.id for r in uploads}
    stages = [r for r in program.spans(view, "engine.stage") or []
              if r.parent in ids]
    return moved / (seconds + program.host_s(stages)) / 1e9
