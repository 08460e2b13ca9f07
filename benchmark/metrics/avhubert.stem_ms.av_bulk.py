"""Median device milliseconds of one group's AV-HuBERT 3D stem: the stream
time between the events of the program's ``avhubert.stem`` span (K5: the
convolution, BatchNorm, PReLU and max-pool in one launch), summed per
``avhubert.visual``. A program without the span gives none."""

from benchmark.core import program


def read(view):
    return program.median_ms_by(program.spans(view, "avhubert.stem") or [],
                                "parent")
