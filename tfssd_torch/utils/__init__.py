"""Utility layer: BatchNorm folding and the Flax -> torch weight bridge."""
