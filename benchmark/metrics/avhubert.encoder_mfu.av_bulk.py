"""The AV-HuBERT encoder's share of the card's peak: the program's counter
``avhubert.encoder_tokens`` x the encoder's FLOPs a token (counted over the
plain reference, ``core/avhubert_flops.py``) / the device seconds of its
``avhubert.encoder`` spans / the peak the configuration names
(``mfu_peak.serve``)."""

from benchmark.core import avhubert_flops, peaks, program


def read(view):
    seconds = program.device_s(program.spans(view, "avhubert.encoder") or [])
    tokens = program.counter("avhubert.encoder_tokens")
    if not seconds or not tokens:
        return None
    cfg = view.ctx.config
    flops = tokens * avhubert_flops.encoder_flops_per_token(cfg["model"])
    return 100.0 * flops / seconds / peaks.peak(cfg["mfu_peak"]["serve"])
