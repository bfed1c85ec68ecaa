"""gather_ms.train: device milliseconds per step in the program's `gather`
span (the batch's rows gathered from the staged dataset, train.py), from
tfssd_torch.utils.profiling.span_summary() over the profiled stretch; 0
where the stretch never entered the span. Training cells; none where nothing
was profiled or the program keeps no spans."""


def read(trace):
    if trace.kind != "train" or trace.count == 0 or trace.busy_s <= 0:
        return None
    try:
        from tfssd_torch.utils.profiling import span_summary
    except ImportError:
        return None
    span = span_summary()["spans"].get("gather", {})
    seconds = span.get("device_s", 0.0)
    return None if seconds is None else 1e3 * seconds / trace.count
