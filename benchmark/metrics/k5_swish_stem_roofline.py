"""K5's Swish instantiation (``csrc/av_stem.cu``, Auto-AVSR's 3D stem):
the least time of the window's launches over their kernel time in the
device trace. A launch's least time is its conv output positions (the
program's counters ``auto_avsr.stem_outputs`` over
``auto_avsr.stem_calls``) times the larger of 2 x 245 x 64 operations at
the bf16 tensor-core peak and 40 bytes at the memory bandwidth
(``core/auto_avsr_flops.py``: ``stem_least_seconds``). In the cells that
list it no other instantiation of the kernel runs, so every
``av_stem_kernel`` launch of the trace is a Swish one. A program without
the counters or the kernel gives none."""

from benchmark.core import auto_avsr_flops, program

KERNELS = ("av_stem_kernel",)


def read(view):
    positions = program.counter("auto_avsr.stem_outputs")
    calls = program.counter("auto_avsr.stem_calls")
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    if not positions or not calls or not launches:
        return None
    per_launch = auto_avsr_flops.stem_least_seconds(positions / calls)
    return 100.0 * per_launch * launches / seconds
