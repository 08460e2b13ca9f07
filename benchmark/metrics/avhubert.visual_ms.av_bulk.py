"""Median device milliseconds of one group's AV-HuBERT visual path: the
stream time between the events of the program's ``avhubert.visual`` span
(the pixel normalisation, the 3D stem, the ResNet-18 trunk and the video
projection), summed per ``engine.forward``."""

from benchmark.core import program


def read(view):
    return program.median_ms_by(program.spans(view, "avhubert.visual") or [],
                                "parent")
