"""K5 (``csrc/av_stem.cu``, AV-HuBERT's 3D stem): the least time of the
window's launches over their kernel time in the device trace. A launch's
least time is its conv output positions (the program's counters
``avhubert.stem_outputs`` over ``avhubert.stem_calls``) times the larger of
2 x 245 x 64 operations at the bf16 tensor-core peak and 40 bytes at the
memory bandwidth (a position's four bf16 pixels read once, its quarter of
the 64 pooled bf16 channels written once), with ``core/peaks.py``'s peaks.
A program without the counters or the kernel gives none."""

from benchmark.core import peaks, program

KERNELS = ("av_stem_kernel",)
TAPS = 5 * 7 * 7
CHANNELS = 64


def read(view):
    positions = program.counter("avhubert.stem_outputs")
    calls = program.counter("avhubert.stem_calls")
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    if not positions or not calls or not launches:
        return None
    per_position = peaks.least_seconds(2 * 4 + 2 * CHANNELS / 4,
                                       2 * TAPS * CHANNELS, "bf16")
    return 100.0 * per_position * positions / calls * launches / seconds
