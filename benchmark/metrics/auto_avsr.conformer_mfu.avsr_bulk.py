"""The Auto-AVSR conformers' share of the card's peak: the program's counter
``auto_avsr.encoder_tokens`` x 2 encoders x one encoder's FLOPs a token
(counted over the plain reference, ``core/auto_avsr_flops.py``) / the
device seconds of both encoders' spans (``auto_avsr.video_encoder``,
``auto_avsr.audio_encoder``) / the peak the configuration names
(``mfu_peak.serve``). A program without the counter or the spans gives
none."""

from benchmark.core import auto_avsr_flops, peaks, program

SPANS = ("auto_avsr.video_encoder", "auto_avsr.audio_encoder")


def read(view):
    records = []
    for name in SPANS:
        records += program.spans(view, name) or []
    seconds = program.device_s(records)
    tokens = program.counter("auto_avsr.encoder_tokens")
    if not seconds or not tokens:
        return None
    cfg = view.ctx.config
    flops = 2 * tokens * auto_avsr_flops.encoder_flops_per_token(cfg["model"])
    return 100.0 * flops / seconds / peaks.peak(cfg["mfu_peak"]["serve"])
