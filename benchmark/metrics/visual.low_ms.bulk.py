"""Median device milliseconds of one group's visual stem, its pool and
layers 1-2: the stream time between the events of the program's
``visual.low`` span (the residual blocks' convolutions on K6 where the
model takes it, on cuDNN or K3 elsewhere), summed per ``engine.forward``.
A program without the span gives none."""

from benchmark.core import program


def read(view):
    return program.median_ms_by(program.spans(view, "visual.low") or [],
                                "parent")
