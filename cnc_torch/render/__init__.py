"""Ray marching (K4), volume rendering (K5) and the eval renderer."""
