"""K2 (``csrc/hf_stem.cu``, the artifact branch's fused Laplacian + conv1 +
BatchNorm + ReLU): its least time (``core/peaks.py::k2_hf_stem``, from the
shapes the benchmark saw it given) over its kernels' time in the device
trace, over the window's launches."""

from benchmark.core import peaks

KERNELS = ("hf_stem_kernel",)


def read(view):
    calls = view.ctx.spans.counters.get("k2_hf_stem", [])
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    if not calls or not launches:
        return None
    least = sum(peaks.k2_hf_stem(shape, size) for shape, size in calls)
    return 100.0 * least * launches / len(calls) / seconds
