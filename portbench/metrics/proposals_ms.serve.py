"""proposals_ms.serve: device milliseconds per request in the program's
`proposals` span: each level's top-k objectness, decode, clip, NMS by level
and the top proposals (tfssd_torch/models/decoder.py: rpn_proposals), from
tfssd_torch.utils.profiling.span_summary() over the profiled stretch. Mask
R-CNN's serving cell; none where nothing was profiled or the program has no
such span."""


def read(trace):
    if trace.kind != "serve" or trace.count == 0 or trace.busy_s <= 0:
        return None
    try:
        from tfssd_torch.utils.profiling import span_summary
    except ImportError:
        return None
    span = span_summary()["spans"].get("proposals")
    if span is None or span.get("device_s") is None:
        return None
    return 1e3 * span["device_s"] / trace.count
