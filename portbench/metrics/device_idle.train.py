"""device_idle.train: the share of the profiled stretch's host-clock
window in which no operation ran on the device (1 - busy / window), in %.
Train cells; none where nothing was profiled."""


def read(trace):
    if trace.kind != "train" or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
