"""Median device milliseconds a train step spends in the program's
``train.backward`` span (the gradients zeroed, then the backward): the
stream time between the span's events, with any wait on the host's
launches, summed per ``train.step``."""

from benchmark.core import program


def read(view):
    return program.median_ms_by(
        program.spans(view, "train.backward") or [], "root")
