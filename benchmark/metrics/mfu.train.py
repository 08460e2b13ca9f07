"""The whole train step's share of the card's peak: steps x FLOPs of one
step at the cell's batch (both forwards and the backward, counted over the
plain reference, ``core/flops.py``) / the window's seconds / the peak the
configuration names (``mfu_peak.train``: fp32 outside the tensor cores)."""

from benchmark.core import flops, peaks


def read(view):
    if view.ctx.device.type != "cuda":
        return None
    cfg, r = view.ctx.config, view.result
    batch = r["clips"] // max(1, r["steps"])
    per_step = flops.train_step_flops(cfg["model"], batch)
    return 100.0 * r["steps"] * per_step / r["elapsed"] \
        / peaks.peak(cfg["mfu_peak"]["train"])
