"""mfu.serve: the model's forward FLOPs per image (counted once by
torch.utils.flop_counter over the benchmark's plain reference model)
times the images per second of the unprofiled window, over the H100's
float32 peak (67 TFLOP/s, TF32 off), in %. Serving cells.
"""

from portbench.peaks import F32_FLOP_PER_S


def read(trace):
    if (trace.kind != "serve" or trace.items_per_s <= 0
            or trace.busy_s <= 0):
        return None
    return 100.0 * trace.flops_per_item * trace.items_per_s / F32_FLOP_PER_S
