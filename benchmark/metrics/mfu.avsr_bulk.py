"""Auto-AVSR's whole forward's share of the card's peak in bulk scoring:
windows scored x FLOPs of one window's forward (counted over the plain
reference, ``core/auto_avsr_flops.py``) / the window's seconds / the peak
the configuration names (``mfu_peak.serve``)."""

from benchmark.core import auto_avsr_flops, peaks


def read(view):
    if view.ctx.device.type != "cuda":
        return None
    cfg, r = view.ctx.config, view.result
    per_window = auto_avsr_flops.forward_flops(cfg["model"], 1)
    rate = r["windows"] * per_window / r["elapsed"]
    return 100.0 * rate / peaks.peak(cfg["mfu_peak"]["serve"])
