"""Share of the window the host spends inside ``ScoringEngine.dispatch_logits``
(pad, uint8 rounding, pageable upload and launch of one group), from the
benchmark's spans around each call."""


def read(view):
    spans = view.ctx.spans
    if not spans.durations("dispatch_logits"):
        return None
    return 100.0 * spans.total("dispatch_logits") / view.result["elapsed"]
