"""Cameras and procedural scenes."""
