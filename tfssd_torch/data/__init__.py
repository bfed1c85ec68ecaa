"""Data layer: synthetic scenes and padded numpy batches."""
