"""conv_ms.serve: device milliseconds per request in the kernels launched
under aten::convolution in the profiled
stretch. Serve cells; none where nothing was profiled."""


def read(trace):
    if trace.kind != "serve" or trace.count == 0 or trace.busy_s <= 0:
        return None
    return 1e3 * trace.conv_s / trace.count
