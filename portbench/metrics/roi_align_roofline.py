"""roi_align_roofline: the least time a request's RoIAlign calls could take
on the H100 over their device time per request in the profiled stretch,
in %. A request makes the calls the driver lists in trace.shapes
["roi_align"] (boxes R, channels C, side P of each: Mask R-CNN's box head
and mask head), each one launch of the program's tfssd::roi_align
(tfssd_torch/csrc/roi_align.cu). A call's bound is the larger of its
bytes over HBM_BYTES_PER_S and its operations over F32_FLOP_PER_S
(portbench/peaks.py): the R x C x P x P float32 outputs written once and
the boxes and their levels read once (the map values a call reads depend
on where its boxes lie and are left out), against OPS_PER_OUTPUT
operations an output. Mask R-CNN's serving cell; none where the kernel
did not run."""

from portbench.peaks import F32_FLOP_PER_S, HBM_BYTES_PER_S
from portbench.trace import kernel_seconds

# Operations of one output: 4 samples of 4 products and 3 sums, each
# added to the bin's sum, and the divide by the count; the samples'
# positions and weights are made once a box, for all its channels, and
# left out.
OPS_PER_OUTPUT = 4 * (4 + 3 + 1) + 1


def call_bound_s(rois: int, channels: int, side: int) -> float:
    """The least seconds of one call over `rois` boxes."""
    outputs = rois * channels * side * side
    t_bytes = (outputs * 4 + rois * (16 + 8)) / HBM_BYTES_PER_S
    t_ops = outputs * OPS_PER_OUTPUT / F32_FLOP_PER_S
    return max(t_bytes, t_ops)


def read(trace):
    calls = kernel_seconds(trace, "roi_align")
    if (trace.kind != "serve" or calls is None or trace.count == 0
            or "roi_align" not in trace.shapes):
        return None
    bound = sum(call_bound_s(*c) for c in trace.shapes["roi_align"])
    return 100.0 * bound / (sum(calls) / trace.count)
