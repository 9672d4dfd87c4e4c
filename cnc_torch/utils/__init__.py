"""Metrics, checkpoint reading and device selection."""
