"""nms_keep_roofline: the least time one nms_keep call could take on the
H100 (peaks.keep_bound_s over the call's R instances of K candidates,
operations or bytes, whichever bounds it) over its mean device time per
launch in the profiled stretch, in %. Serving cells; none where the kernel
did not run."""

from portbench.peaks import keep_bound_s
from portbench.trace import kernel_seconds


def read(trace):
    calls = kernel_seconds(trace, "nms_keep")
    if trace.kind != "serve" or calls is None:
        return None
    bound, _ = keep_bound_s(trace.shapes["keep_r"], trace.shapes["keep_k"])
    return 100.0 * bound / (sum(calls) / len(calls))
