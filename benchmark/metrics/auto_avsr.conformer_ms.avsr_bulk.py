"""Median device milliseconds of one group's two Auto-AVSR conformer
encoders: the stream time between the events of the program's
``auto_avsr.video_encoder`` and ``auto_avsr.audio_encoder`` spans (each the
positional encoding, 12 blocks and ``after_norm``), summed per
``engine.forward``. A program without the spans gives none."""

from benchmark.core import program

SPANS = ("auto_avsr.video_encoder", "auto_avsr.audio_encoder")


def read(view):
    records = []
    for name in SPANS:
        records += program.spans(view, name) or []
    return program.median_ms_by(records, "parent")
