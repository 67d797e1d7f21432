"""Core layers, attention, temporal and residual blocks, schedulers."""
