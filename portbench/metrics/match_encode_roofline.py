"""match_encode_roofline: the least time one match_encode call could take
on the H100 (peaks.match_bound_s over the step's N anchors, B x G padded
gts and the batch's real gts, operations or bytes, whichever bounds it)
over its mean device time per launch in the profiled stretch, in %. The
real gts are the rows' before augmentation, which can only drop some:
the bound is bytes at these sizes either way. Training cells; none where
the kernel did not run."""

from portbench.peaks import match_bound_s
from portbench.trace import kernel_seconds


def read(trace):
    calls = kernel_seconds(trace, "match_encode")
    if trace.kind != "train" or calls is None:
        return None
    s = trace.shapes
    bound, _ = match_bound_s(s["anchors"], s["batch"], s["max_gt"],
                             s["real_gts"])
    return 100.0 * bound / (sum(calls) / len(calls))
