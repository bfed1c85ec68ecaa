"""select_ms.serve: device milliseconds per request in the program's
`select` span (the prefilter and the per-class top-K, ops/nms.py), from
tfssd_torch.utils.profiling.span_summary() over the profiled stretch; 0
where the stretch never entered the span. Serving cells; none where nothing
was profiled or the program keeps no spans."""


def read(trace):
    if trace.kind != "serve" or trace.count == 0 or trace.busy_s <= 0:
        return None
    try:
        from tfssd_torch.utils.profiling import span_summary
    except ImportError:
        return None
    span = span_summary()["spans"].get("select", {})
    seconds = span.get("device_s", 0.0)
    return None if seconds is None else 1e3 * seconds / trace.count
