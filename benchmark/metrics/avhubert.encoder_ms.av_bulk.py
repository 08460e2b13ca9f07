"""Median device milliseconds of one group's AV-HuBERT encoder: the stream
time between the events of the program's ``avhubert.encoder`` span (the
positional convolution, the transformer layers and the final LayerNorm),
summed per ``engine.forward``."""

from benchmark.core import program


def read(view):
    return program.median_ms_by(program.spans(view, "avhubert.encoder") or [],
                                "parent")
