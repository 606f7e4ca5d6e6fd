"""Interactive session: memory bank and inference core."""
