"""K6 (``csrc/conv3d_tf32x3.cu``, the visual encoder's fp32 residual-block
convolutions on the tensor cores in 3xTF32): the least time of the
window's launches over their kernel time in the device trace. A launch's
least time is its FLOPs (the program's counters ``visual.k6_flops`` over
``visual.k6_calls``: twice the multiply-adds of the fp32 convolution) at
the single-pass TF32 peak of ``core/peaks.py``. A 3xTF32 kernel issues
three TF32 products for each, so the share reads at most 33%; the memory
term is left out (it would matter only for the 1x1x1 shortcut), so the
share can under-read, never over-read. A program without the counters or
the kernel gives none."""

from benchmark.core import peaks, program

KERNELS = ("conv3d_tf32x3_kernel",)


def read(view):
    flops = program.counter("visual.k6_flops")
    calls = program.counter("visual.k6_calls")
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    if not flops or not calls or not launches:
        return None
    per_launch = peaks.least_seconds(0, flops / calls, "tf32")
    return 100.0 * per_launch * launches / seconds
