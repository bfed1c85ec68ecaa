"""candidates.serve: candidates entering RetinaNet's class-wise NMS per
image in the profiled stretch (the program's counter `select/candidates`,
tfssd_torch/models/decoder.py: pairs above the score threshold among each
level's top-k), over the requests' images. RetinaNet's serving cell; none
where nothing was profiled or the program keeps no such counter."""


def read(trace):
    if trace.kind != "serve" or trace.count == 0 or trace.busy_s <= 0:
        return None
    try:
        from tfssd_torch.utils.profiling import span_summary
    except ImportError:
        return None
    counters = span_summary()["counters"]
    if "select/candidates" not in counters:
        return None
    return counters["select/candidates"] / (trace.count
                                            * trace.shapes["batch"])
