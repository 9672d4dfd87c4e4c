"""The occupancy grid state."""
