"""Share of the engine's uploaded bytes that went through its pinned
staging ring: the program's counter ``engine.upload_staged_bytes`` over
``engine.upload_bytes``, in %. A program without the ring counts no staged
bytes, and the metric is left out."""

from benchmark.core import program


def read(view):
    staged = program.counter("engine.upload_staged_bytes")
    moved = program.counter("engine.upload_bytes")
    if staged is None or not moved:
        return None
    return 100.0 * staged / moved
