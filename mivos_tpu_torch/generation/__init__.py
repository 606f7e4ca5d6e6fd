"""Synthetic training data: the moving-blob video generator and the
DAVIS-layout writer (counterpart of mivos_tpu/generation/synthetic.py)."""
