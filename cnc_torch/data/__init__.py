"""Cameras, procedural scenes and the file datasets (Blender, Tanks&Temples)."""
