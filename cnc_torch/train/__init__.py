"""Optimizer, schedule and the training loop."""
