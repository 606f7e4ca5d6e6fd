"""Plain PyTorch reference of MiVOS inference (float32, TF32 off, exact
top-k read). Imports nothing of the program under test."""
