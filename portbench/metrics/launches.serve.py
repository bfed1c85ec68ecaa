"""launches.serve: device kernels launched per request in the profiled
stretch (copies and memsets not counted). Serve cells; none where
nothing was profiled."""


def read(trace):
    if trace.kind != "serve" or trace.count == 0 or not trace.kernels:
        return None
    return len(trace.kernels) / trace.count
