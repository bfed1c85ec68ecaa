"""match_gts.train: real gts per image that enter the match in the profiled
stretch, after augmentation (the program's counter `match/real_gts`,
tfssd_torch/train.py), over the steps' images. Training cells; none where
nothing was profiled or the program keeps no counters."""


def read(trace):
    if trace.kind != "train" or trace.count == 0 or trace.busy_s <= 0:
        return None
    try:
        from tfssd_torch.utils.profiling import span_summary
    except ImportError:
        return None
    gts = span_summary()["counters"].get("match/real_gts", 0)
    return gts / (trace.count * trace.shapes["batch"])
