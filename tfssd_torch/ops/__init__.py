"""Ops layer: box geometry, combined NMS and the hand-written kernels."""
