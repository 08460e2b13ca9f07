"""Median device milliseconds of one group's forward: the stream time
between the events of the program's ``engine.forward`` span (the ``/255``
conversion and the model, with any wait on the host's launches), summed
per ``engine.dispatch``."""

from benchmark.core import program


def read(view):
    return program.median_ms_by(program.spans(view, "engine.forward") or [],
                                "parent")
