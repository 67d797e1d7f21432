"""Logging, metric trackers, the profile window and preemption."""
