"""The CNC radiance field."""
