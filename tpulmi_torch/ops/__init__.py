"""Tensor ops: distances, k-means, and the probe kernel with its plain version."""
