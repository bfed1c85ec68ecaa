"""conv_ms.train: device milliseconds per step in the kernels launched
under aten::convolution and aten::convolution_backward in the profiled
stretch. Train cells; none where nothing was profiled."""


def read(trace):
    if trace.kind != "train" or trace.count == 0 or trace.busy_s <= 0:
        return None
    return 1e3 * trace.conv_s / trace.count
