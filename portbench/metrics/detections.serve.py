"""detections.serve: boxes entering Mask R-CNN's mask head per image in the
profiled stretch (the program's counter `mask/detections`,
tfssd_torch/models/maskrcnn.py: the valid detections of each image), over
the requests' images. Mask R-CNN's serving cell; none where nothing was
profiled or the program keeps no such counter."""


def read(trace):
    if trace.kind != "serve" or trace.count == 0 or trace.busy_s <= 0:
        return None
    try:
        from tfssd_torch.utils.profiling import span_summary
    except ImportError:
        return None
    counters = span_summary()["counters"]
    if "mask/detections" not in counters:
        return None
    return counters["mask/detections"] / (trace.count
                                          * trace.shapes["batch"])
