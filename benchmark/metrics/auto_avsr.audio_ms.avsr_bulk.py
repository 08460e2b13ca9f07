"""Median device milliseconds of one group's Auto-AVSR audio front end: the
stream time between the events of the program's ``auto_avsr.audio`` span
(the PCM normalisation, the ResNet-18-1D and the audio projection), summed
per ``engine.forward``. A program without the span gives none."""

from benchmark.core import program


def read(view):
    return program.median_ms_by(program.spans(view, "auto_avsr.audio") or [],
                                "parent")
