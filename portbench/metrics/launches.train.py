"""launches.train: device kernels launched per step in the profiled
stretch (copies and memsets not counted). Train cells; none where
nothing was profiled."""


def read(trace):
    if trace.kind != "train" or trace.count == 0 or not trace.kernels:
        return None
    return len(trace.kernels) / trace.count
