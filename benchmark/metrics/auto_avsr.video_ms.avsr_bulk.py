"""Median device milliseconds of one group's Auto-AVSR video front end: the
stream time between the events of the program's ``auto_avsr.video`` span
(the pixel normalisation, the 3D stem, the ResNet-18 trunk and the video
projection), summed per ``engine.forward``. A program without the span
gives none."""

from benchmark.core import program


def read(view):
    return program.median_ms_by(program.spans(view, "auto_avsr.video") or [],
                                "parent")
