"""Interaction-to-mask: scribble rasterization and the S2M controller."""
