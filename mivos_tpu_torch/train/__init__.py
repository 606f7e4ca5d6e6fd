"""Fusion-module training: losses, the trainer and the entry point
(`python -m mivos_tpu_torch.train`)."""
