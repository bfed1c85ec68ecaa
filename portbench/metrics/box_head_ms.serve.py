"""box_head_ms.serve: device milliseconds per request in the program's
`box_head` span: RoIAlign of the proposals to 7x7 and the box head's linear
layers (tfssd_torch/models/maskrcnn.py), from
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
    span = span_summary()["spans"].get("box_head")
    if span is None or span.get("device_s") is None:
        return None
    return 1e3 * span["device_s"] / trace.count
