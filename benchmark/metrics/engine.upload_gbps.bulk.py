"""The rate of the engine's uploads: the program's counter
``engine.upload_bytes`` over the device seconds of its ``engine.upload``
spans (stream events around the copies), in GB/s."""

from benchmark.core import program


def read(view):
    uploads = program.spans(view, "engine.upload")
    seconds = program.device_s(uploads or [])
    moved = program.counter("engine.upload_bytes")
    if not seconds or not moved:
        return None
    return moved / seconds / 1e9
