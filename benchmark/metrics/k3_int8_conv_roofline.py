"""K3 (``csrc/int8_conv.cu``, the int8 encoder convolutions): the least
time of every launch (``core/peaks.py::k3_int8_conv``, from the shapes the
benchmark saw it given: 24 a forward) over its kernels' time in the device
trace, over the window's launches."""

from benchmark.core import peaks

KERNELS = ("int8_conv_wgmma", "int8_conv_halo")


def read(view):
    calls = view.ctx.spans.counters.get("k3_int8_conv", [])
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    if not calls or not launches:
        return None
    least = sum(peaks.k3_int8_conv(*call) for call in calls)
    return 100.0 * least * launches / len(calls) / seconds
