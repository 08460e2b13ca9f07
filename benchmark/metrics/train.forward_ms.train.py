"""Median device milliseconds a train step spends in the program's
``train.forward`` span (both forwards, the three losses and the
accuracy): the stream time between the span's events, with any wait on
the host's launches, summed per ``train.step``."""

from benchmark.core import program


def read(view):
    return program.median_ms_by(
        program.spans(view, "train.forward") or [], "root")
